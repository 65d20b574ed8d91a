"""The ``mesh=`` routes of the port beyond the filter itself: the sharded
LGCP filter and ``OnlineFilter(mesh=)`` in a 2-rank gloo world (each
within 4 joint se of its one-device route over 8 seeds), the one-shard
delegation to the fused filter in a world of one in this process (bit for
bit), the checks that keep CUDA on NCCL, the filtering app with ``--mesh``
under ``torch.distributed.run`` with 2 ranks, and the dry run in 4."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj
from composablestatespacemodels_torch.parallel import (
    PARTICLE_AXIS, initialize_distributed, particle_mesh)
from composablestatespacemodels_torch.parallel import sharded_filter as sf

from _torch_dist import ROOT, WORLD_TIMEOUT, run_world

SEEDS = np.arange(8)
N_ROUTES = 128


def _se(v):
    return np.std(v, ddof=1) / np.sqrt(len(v))


@pytest.fixture(scope="module")
def routes_world(tmp_path_factory):
    model = cj.linear(cj.brownian_motion(1))
    params = cj.parameters(np.log(0.5), cj.brownian_params(0.0, 1.0, 0.4))
    data = cj.simulate_regular(model, params, jax.random.PRNGKey(8), 30,
                               dt=1.0).to_timeseries()
    events = np.sort(np.random.default_rng(4).uniform(0.0, 8.0, 10))
    inputs = {"ts": np.asarray(data.ts), "ys": np.asarray(data.ys),
              "mask": np.asarray(data.mask), "n": np.array(N_ROUTES),
              "seeds": SEEDS, "events": events.astype(np.float32)}
    return run_world("routes", 2, inputs, tmp_path_factory.mktemp("r"))


@pytest.mark.parametrize("route", ["lgcp", "online"])
def test_sharded_route_within_joint_se_of_one_device(routes_world, route):
    r0 = routes_world[0]
    a, b = r0[f"{route}/sharded"], r0[f"{route}/single"]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    joint = np.sqrt(_se(a) ** 2 + _se(b) ** 2)
    assert abs(a.mean() - b.mean()) <= 4 * joint, (a.mean(), b.mean())
    np.testing.assert_array_equal(routes_world[1][f"{route}/sharded"], a)


def test_lgcp_sharded_summaries_and_cloud(routes_world):
    r = routes_world[0]
    assert (r["lgcp/eta_lower"] <= r["lgcp/eta_upper"]).all()
    assert (r["lgcp/state_lower"] <= r["lgcp/state_upper"]).all()
    assert ((r["lgcp/ess"] >= 1) & (r["lgcp/ess"] <= N_ROUTES)).all()
    assert tuple(r["lgcp/final_shape"]) == (N_ROUTES, 1)


def test_online_filter_carries_a_sharded_cloud(routes_world):
    assert list(routes_world[0]["online/kinds"]) == ["DTensor"]
    assert all(r["gen_agree"] for r in routes_world)


# ---------------------------------------------------------------------------
# a world of one in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world_of_one():
    initialize_distributed("cpu", timeout=60)
    yield particle_mesh("cpu")
    dist.destroy_process_group()


def _oracle_port(t_len=20):
    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(np.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    data = ct.simulate_regular(model, params, torch.Generator().manual_seed(2),
                               t_len, dt=1.0).to_timeseries()
    return model, params, data


def test_one_shard_fused_delegation_bit_equal(world_of_one):
    """One shard, store "ll", no ESS trigger, N % 1024 == 0: the fused
    single-device filter (K1, K2), with the same draws."""
    model, params, data = _oracle_port()
    got = ct.bootstrap_filter(model, params, data, 1024,
                              torch.Generator().manual_seed(3), store="ll",
                              resample="systematic-pallas-fused",
                              mesh=world_of_one)
    want = ct.bootstrap_filter(model, params, data, 1024,
                               torch.Generator().manual_seed(3), store="ll",
                               resample="systematic-fused")
    assert torch.equal(got.ll, want.ll)
    assert torch.equal(got.ll_history, want.ll_history)
    assert torch.equal(got.ess, want.ess)
    assert torch.equal(got.final_particles.to_local(), want.final_particles)


def test_one_shard_ring_free_route(world_of_one):
    """One shard without the delegation: the same window counts through
    the local gather, and the store modes' shapes."""
    model, params, data = _oracle_port()
    for store in ("summary", "path", "ll"):
        res = ct.bootstrap_filter(model, params, data, 100,
                                  torch.Generator().manual_seed(4),
                                  store=store, mesh=world_of_one)
        assert torch.isfinite(res.ll)
        assert tuple(res.final_particles.shape) == (100, 1)


def test_one_shard_plain_fill_same_bits(world_of_one):
    """``pallas_fill=False`` (the fill by search) gives K4's bits."""
    model, params, data = _oracle_port()
    lls = [ct.bootstrap_filter(model, params, data, 100,
                               torch.Generator().manual_seed(6), store="ll",
                               mesh=world_of_one, **kw).ll
           for kw in ({}, {"pallas_fill": False})]
    assert torch.equal(*lls)


def test_placement_helpers(world_of_one):
    """The multihost helpers in a world of one: the hybrid mesh, this
    rank's slice of a global cloud as a DTensor that the filter takes as
    its initial state, a replicated tree, the node's chains."""
    from composablestatespacemodels_torch.parallel import (
        hybrid_mesh, process_local_chains, replicate_to_mesh,
        shard_particles_to_mesh)
    mesh = hybrid_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("chains", "particles")
    assert tuple(mesh.shape) == (1, 1)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    cloud = shard_particles_to_mesh(x, mesh)
    np.testing.assert_array_equal(cloud.full_tensor().numpy(), x)
    model, params, data = _oracle_port()
    arr, series = replicate_to_mesh((np.ones(3), data), mesh)
    assert isinstance(arr, torch.Tensor) and torch.equal(series.ys, data.ys)
    assert process_local_chains(2) == range(0, 2)
    init = shard_particles_to_mesh(np.full((64, 1), 0.5, np.float32), mesh)
    res = ct.bootstrap_filter(model, params, data, 64,
                              torch.Generator().manual_seed(1), store="ll",
                              initial_state=init, mesh=world_of_one)
    ref = ct.bootstrap_filter(model, params, data, 64,
                              torch.Generator().manual_seed(1), store="ll",
                              initial_state=np.array([0.5], np.float32),
                              mesh=world_of_one)
    assert torch.equal(res.ll, ref.ll)


def test_cuda_stays_on_nccl(world_of_one):
    with pytest.raises(ValueError, match="need nccl"):
        initialize_distributed("cuda")
    with pytest.raises(ValueError, match="CUDA runs over NCCL"):
        sf._Shards(world_of_one, PARTICLE_AXIS, torch.device("cuda"))
    with pytest.raises(TypeError, match="only valid with mesh="):
        ct.bootstrap_filter(*_oracle_port(), 8, torch.Generator(),
                            resample_comm="allgather")


# ---------------------------------------------------------------------------
# the app under torch.distributed.run, and the dry run
# ---------------------------------------------------------------------------


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def test_filtering_app_with_mesh_under_torchrun(tmp_path):
    from composablestatespacemodels_torch.examples import simulate
    data = str(tmp_path / "d")
    simulate.main(["model", "--n-obs", "20", "--out", data, "--device",
                   "cpu"])
    out = str(tmp_path / "f")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m",
         "composablestatespacemodels_torch.examples.filtering",
         data + "_sims.json", "--n-particles", "64", "--device", "cpu",
         "--mesh", "--out", out],
        capture_output=True, text=True, cwd=ROOT, env=_env(),
        timeout=WORLD_TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "mesh: 2 rank(s) on the particle axis" in run.stdout
    rows = np.loadtxt(out + "_filtered.csv", delimiter=",")
    assert rows.shape == (20, 4 + 9 + 1)
    assert (rows[:, 2] <= rows[:, 3]).all()


def test_dryrun_four_ranks():
    run = subprocess.run(
        [sys.executable, "-m",
         "composablestatespacemodels_torch.parallel.dryrun", "4"],
        capture_output=True, text=True, cwd=ROOT, env=_env(),
        timeout=WORLD_TIMEOUT + 30)
    assert run.returncode == 0, run.stderr[-3000:]
    line = run.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): mesh={'chains': 2, "
                           "'particles': 2} n_particles=32 ")
    assert line.endswith(" OK")
