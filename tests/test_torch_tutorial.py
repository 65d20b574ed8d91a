"""Execute every fenced python block of docs/tutorial_torch.md on the CPU.

The tutorial is written for the card: its first block sets
``device = "cuda"`` on one line, and every generator and tensor follows
that line.  Here that one line becomes ``device = "cpu"``, so the
kernels' plain PyTorch versions run; ``chip_smoke.py`` runs the blocks
unchanged on the H100.
"""

import pathlib
import re

import torch.distributed as dist

DOC = pathlib.Path(__file__).parent.parent / "docs" / "tutorial_torch.md"
DEVICE_LINE = 'device = "cuda"\n'


def test_tutorial_blocks_execute_on_cpu():
    src = DOC.read_text()
    assert src.count(DEVICE_LINE) == 1
    blocks = re.findall(r"```python\n(.*?)```",
                        src.replace(DEVICE_LINE, 'device = "cpu"\n'),
                        flags=re.DOTALL)
    assert len(blocks) >= 6
    ns = {}
    try:
        for i, block in enumerate(blocks):
            try:
                exec(compile(block, f"tutorial block {i}", "exec"), ns)
            except Exception as e:
                raise AssertionError(
                    f"tutorial block {i} failed: {e}\n---\n{block}") from e
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert ns["device"] == "cpu" and ns["gen"].device.type == "cpu"
