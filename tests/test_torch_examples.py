"""The port's example apps (``composablestatespacemodels_torch.examples``)
end to end at tiny sizes on the CPU (``--device cpu``): each app's
``main()`` in-process, its files checked for shape and content, the JAX
package's readers reading the port's files to the port's values (bit for
bit), and the port's ``tocsv`` of a JAX-written posterior byte-identical
to the JAX app's."""

from __future__ import annotations

import runpy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.examples import (determine_parameters,
                                                       filtering, interpolate,
                                                       simulate)
from composablestatespacemodels_torch.utils import io as tio
from composablestatespacemodels_tpu.inference.pmmh import PmmhResult
from composablestatespacemodels_tpu.models import params as jparams
from composablestatespacemodels_tpu.models import tree as jtree
from composablestatespacemodels_tpu.utils import io as jio

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _rows(path):
    return np.asarray([ln.split(",") for ln in
                       Path(path).read_text().strip().split("\n")],
                      dtype=float)


def _png(path):
    assert Path(path).read_bytes()[:4] == b"\x89PNG"


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sims") / "d")
    simulate.main(["model", "--n-obs", "40", "--out", out, "--plot", *CPU])
    return out


def test_simulate_model_files(sims):
    assert _rows(sims + "_sims.csv").shape == (40, 4 + 9)
    _png(sims + "_sims.png")
    got = tio.read_timeseries_json(sims + "_sims.json", device="cpu")
    jax_got = jio.read_timeseries_json(sims + "_sims.json")
    for f in ("ts", "ys", "mask"):
        np.testing.assert_array_equal(np.asarray(getattr(jax_got, f)),
                                      getattr(got, f).numpy())
    np.testing.assert_array_equal(_rows(sims + "_sims.csv")[:, :2],
                                  np.stack([got.ts, got.ys], 1))


@pytest.mark.parametrize("what, rows, cols", [("ornstein", 31, 2),
                                              ("seasonal", 30, 4 + 6)])
def test_simulate_other_apps(tmp_path, what, rows, cols):
    out = str(tmp_path / "s")
    simulate.main([what, "--n-obs", "30", "--out", out, *CPU])
    name = {"ornstein": "_ou.csv", "seasonal": "_seasonal.csv"}[what]
    assert _rows(out + name).shape == (rows, cols)


def test_simulate_lgcp(tmp_path):
    out = str(tmp_path / "lg")
    simulate.main(["lgcp", "--out", out, *CPU])
    ev = _rows(out + "_lgcp.csv")
    assert ev.shape[1] == 5 and (ev[:, 1] == 1.0).all()
    assert (np.diff(ev[:, 0]) > 0).all() and (ev[:, 0] <= 10.0).all()


def test_filtering(sims, tmp_path):
    out = str(tmp_path / "f")
    filtering.main([sims + "_sims.json", "--n-particles", "64", "--out", out,
                    "--plot", *CPU])
    rows = _rows(out + "_filtered.csv")
    assert rows.shape == (40, 4 + 9 + 1)
    assert (rows[:, 2] <= rows[:, 3]).all() and np.isfinite(rows).all()
    _png(out + "_filtered.png")


def test_determine_parameters_chains_and_tocsv(sims, tmp_path, capsys):
    """Two chains on the chain axis and on the sweep (K8's plain version);
    the JAX reader reads the port's posterior; tocsv writes the names."""
    for extra, out in (([], "p"), (["--fused-sweep"], "pf")):
        determine_parameters.main(
            ["posterior", sims + "_sims.json", "--n-iters", "4",
             "--n-particles", "32", "--chains", "2", "--out",
             str(tmp_path / out), *extra, *CPU])
        assert "R-hat(ll)" in capsys.readouterr().out
        post = str(tmp_path / out) + "_posterior_1.json"
        jst, jll, jacc = jio.read_posterior_json(post)
        tst, tll, tacc = tio.read_posterior_json(post, device="cpu")
        np.testing.assert_array_equal(np.asarray(jll), tll.numpy())
        np.testing.assert_array_equal(np.asarray(jacc), tacc.numpy())
        np.testing.assert_array_equal(
            np.asarray(jparams.stack_flat(jst)),
            ct.models.stack_flat(tst).numpy())
        assert len(jll) == 4 and np.isfinite(np.asarray(jll)).all()
    csv = str(tmp_path / "post.csv")
    determine_parameters.main(["tocsv", post, csv, *CPU])
    header = Path(csv).read_text().split("\n")[0].split(",")
    assert header[0] == "scale" and header[-1] == "ll" and len(header) == 12


def test_determine_parameters_monitored_chain(sims, tmp_path, capsys):
    """The single chain runs through pmmh_monitored with its checkpoint;
    a second run of the app resumes from it."""
    out = str(tmp_path / "m")
    argv = ["posterior", sims + "_sims.json", "--n-iters", "5",
            "--n-particles", "32", "--chains", "1", "--out", out, "--plot",
            *CPU]
    determine_parameters.main(argv)
    first = Path(out + "_posterior.json").read_text()
    assert len(first.strip().split("\n")) == 5
    assert Path(out + "_chain.npz").exists()
    _png(out + "_posterior.png")
    _png(out + "_diagnostics.png")
    determine_parameters.main(argv)
    assert "resumed from" in capsys.readouterr().err
    assert Path(out + "_posterior.json").read_text() == first


def test_determine_parameters_pilot_and_adaptive(tmp_path, capsys):
    out = str(tmp_path / "d")
    simulate.main(["model", "--n-obs", "8", "--out", out, *CPU])
    determine_parameters.main(["pilot", out + "_sims.json", "--plot",
                               "--out", out, *CPU])
    lines = capsys.readouterr().out.strip().split("\n")
    assert lines[1] == "n_particles, mean_ll, var_ll"
    assert [int(ln.split(",")[0]) for ln in lines[2:7]] == [100, 200, 500,
                                                             1000, 2000]
    _png(out + "_pilot.png")
    determine_parameters.main(["posterior", out + "_sims.json", "--n-iters",
                               "4", "--n-particles", "8", "--chains", "1",
                               "--adaptive", "--out", out, *CPU])
    assert "acceptance (adapted chain)" in capsys.readouterr().out
    assert len(Path(out + "_posterior.json").read_text().split("\n")) == 5


@pytest.mark.parametrize("resample", ["systematic", "stratified"])
def test_interpolate(tmp_path, resample):
    out = str(tmp_path / "i")
    interpolate.main(["--n-obs", "50", "--knock-lo", "20", "--knock-hi",
                      "30", "--n-particles", "64", "--resample", resample,
                      "--out", out, *CPU])
    arr = _rows(out + "_interpolated.csv")
    assert arr.shape == (50, 5)
    np.testing.assert_array_equal(arr[:, 4], (arr[:, 0] < 20)
                                  | (arr[:, 0] > 30))
    assert (arr[:, 2] <= arr[:, 3]).all()


def test_no_mesh_flag_yet(sims, tmp_path):
    """``--mesh`` now exists: both apps run it under plain ``python -m``,
    on a world of one rank (gloo on the CPU), and write what the one-device
    routes write."""
    import torch.distributed as dist
    out = str(tmp_path / "m")
    try:
        filtering.main([sims + "_sims.json", "--n-particles", "32",
                        "--mesh", "--out", out, *CPU])
        determine_parameters.main(["posterior", sims + "_sims.json",
                                   "--mesh", "--chains", "2",
                                   "--n-particles", "16", "--n-iters", "3",
                                   "--out", out, *CPU])
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    arr = _rows(out + "_filtered.csv")
    assert arr.shape == (40, 4 + 9 + 1) and (arr[:, 2] <= arr[:, 3]).all()
    # one rank holds one chain row, whatever --chains asks
    _, lls, _ = tio.read_posterior_json(out + "_posterior_0.json",
                                        device="cpu")
    assert lls.shape == (3,) and torch.isfinite(lls).all()
    assert not Path(out + "_posterior_1.json").exists()


def test_tocsv_of_jax_posterior_is_byte_identical(tmp_path, monkeypatch):
    """A JAX-written posterior of the apps' test model, converted by the
    JAX app and by the port's: the same bytes."""
    rng = np.random.default_rng(0)
    n = 6

    def ou(k):
        return jparams.OuParams(*[jnp.asarray(rng.normal(size=(n, k)),
                                              jnp.float32)
                                  for _ in range(5)])

    params = jtree.Branch(
        jtree.Leaf(jparams.ParamNode(
            jnp.asarray(rng.normal(size=n), jnp.float32), ou(1))),
        jtree.Leaf(jparams.ParamNode(None, ou(1))))
    post = str(tmp_path / "jax_posterior.json")
    jio.write_posterior_json(post, PmmhResult(
        params, jnp.asarray(rng.normal(-90, 3, n), jnp.float32),
        jnp.arange(1, n + 1, dtype=jnp.int32)))
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    monkeypatch.setattr(sys, "argv", ["determine_parameters.py", "tocsv",
                                      post, str(jax_csv)])
    monkeypatch.syspath_prepend(str(ROOT))
    runpy.run_path(str(ROOT / "examples" / "determine_parameters.py"),
                   run_name="__main__")
    determine_parameters.main(["tocsv", post, str(port_csv)])
    assert jax_csv.read_bytes() == port_csv.read_bytes()
    assert torch.equal(
        torch.tensor(_rows_skip_header(port_csv)[:, -1], dtype=torch.float32),
        torch.tensor(np.asarray(jio.read_posterior_json(post)[1])))


def _rows_skip_header(path):
    return np.asarray([ln.split(",") for ln in
                       Path(path).read_text().strip().split("\n")[1:]],
                      dtype=float)
