"""The port's sharded PMMH (``parallel/sharded_pmmh.py``) on a 2 x 2
(chains x particles) gloo world on the CPU.

One world runs every tier on the Kalman oracle at N = 32, T = 10 and
returns each rank's gathered ``[n_chains, n_iters]`` results: the shards
of a chain hold the same chain (ranks 0 and 1 gather the two chains from
different particle shards), the chains differ, a resume through
``init_state`` and a resume of ``sharded_pmmh_monitored`` from its
checkpoint return the uninterrupted chain bit for bit, and every rank ends
with the same generator state.
"""

import jax
import numpy as np
import pytest

import composablestatespacemodels_tpu as cj

from _torch_dist import run_world

N, T, ITERS = 32, 10, 4
TAGS = ("plain", "approx", "state", "uncut", "resumed", "adaptive")


@pytest.fixture(scope="module")
def pmmh_world(tmp_path_factory):
    model = cj.linear(cj.brownian_motion(1))
    params = cj.parameters(np.log(0.5), cj.brownian_params(0.0, 1.0, 0.4))
    data = cj.simulate_regular(model, params, jax.random.PRNGKey(5), T,
                               dt=1.0).to_timeseries()
    tmp = tmp_path_factory.mktemp("pmmh")
    inputs = {"ts": np.asarray(data.ts), "ys": np.asarray(data.ys),
              "mask": np.asarray(data.mask), "n": np.array(N),
              "iters": np.array(ITERS), "dir": np.array(str(tmp))}
    return run_world("pmmh", 4, inputs, tmp)


@pytest.mark.parametrize("tag", TAGS)
def test_shards_of_a_chain_agree_and_chains_differ(pmmh_world, tag):
    r0 = pmmh_world[0]
    assert r0[f"{tag}/lls"].shape == (2, ITERS)
    assert np.isfinite(r0[f"{tag}/lls"]).all()
    for r in pmmh_world[1:]:
        for key in r0:
            if key.startswith(f"{tag}/"):
                np.testing.assert_array_equal(r[key], r0[key], key)
    assert not np.array_equal(r0[f"{tag}/params"][0], r0[f"{tag}/params"][1])
    acc = r0[f"{tag}/accepted"]
    assert (np.diff(acc, axis=1) >= 0).all() and (acc[:, 0] == 1).all()


def test_store_state_draws(pmmh_world):
    states = pmmh_world[0]["state/states"]
    assert states.shape == (2, ITERS, 1) and np.isfinite(states).all()


def test_init_state_resume_bit_exact(pmmh_world):
    """The monitored run's two chunks by hand, the second resumed from the
    first's final state."""
    r = pmmh_world[0]
    for key in ("lls", "states"):
        np.testing.assert_array_equal(r[f"by_hand/{key}"], r[f"uncut/{key}"])


def test_monitored_checkpoint_resume_bit_exact(pmmh_world):
    r = pmmh_world[0]
    for key in ("lls", "accepted", "params", "states"):
        np.testing.assert_array_equal(r[f"resumed/{key}"], r[f"uncut/{key}"],
                                      key)


def test_generators_agree_across_ranks(pmmh_world):
    assert all(r["gen_agree"] for r in pmmh_world)
