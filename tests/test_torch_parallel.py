"""The port's meshes, sharding and control signals against the JAX package's.

Restates ``tests/unit/test_parallel.py`` and ``tests/unit/test_control.py``
on four CPU ranks (one ``RankPool`` for the file, each case with its own
timeout so that a deadlock fails that case): mesh shapes, the ``-1`` fill
and the reference's errors, ``trial_devices``' refusals (a repeated id,
ids out of range; the CUDA mapping on a stubbed device count), the active
mesh, ``shard_batch``, ``shard_params`` against the reference's own shards
of ``init_sharded``'s parameters on a CPU mesh of the same shape, and
``pod_agree``/``run_signaled`` with the stop wanted on one rank only.
The MoE's expert sharding keeps the reference's global capacity: a
dp 2 × ep 2 layer's output (bf16 bound, 3e-2 of its scale), dropped
fraction and balance loss against the reference's layer on the whole
batch, on a batch whose dp halves route unevenly, so that capacity per
shard would drop other items (checked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import torch_mesh_legs as legs
from metaopt_tpu.models import moe as jmoe, transformer as jt
from metaopt_tpu.parallel.mesh import make_mesh as jmake_mesh
from metaopt_tpu_torch.models import transformer as tt
from metaopt_tpu_torch.models.moe import MoEFeedForward
from metaopt_tpu_torch.parallel import launch, mesh as pmesh
from metaopt_tpu_torch.parallel.launch import RankPool, RankError

CALL_S = 60   # one case's collectives; a deadlock fails the case, not the suite


@pytest.fixture(scope="module")
def pool():
    with RankPool(["cpu"] * 4, timeout_s=CALL_S) as p:
        yield p


def test_make_mesh_shapes(pool):
    facts = pool.run(legs.mesh_facts, [("dp", 2), ("tp", 2)])
    assert [f["shape"] for f in facts] == [{"dp": 2, "tp": 2}] * 4
    assert [(f["index"]["dp"], f["index"]["tp"]) for f in facts] == [(0, 0), (0, 1),
                                                                      (1, 0), (1, 1)]
    assert facts[0]["device_type"] == "cpu"
    assert pool.run(legs.mesh_facts, [("dp", -1), ("tp", 2)])[0]["shape"] == {"dp": 2, "tp": 2}
    assert pool.run(legs.mesh_facts, [("sp", 4)])[0]["shape"] == {"sp": 4}


@pytest.mark.parametrize("axes,match", [
    ([("dp", 3), ("tp", 2)], "needs 6 devices, have 4"),
    ([("dp", -1), ("tp", -1)], "at most one mesh axis may be -1"),
    ([("dp", -1), ("tp", 3)], "not divisible by fixed axes 3"),
])
def test_make_mesh_errors_are_the_references(pool, axes, match):
    assert all(match in e for e in pool.run(legs.mesh_error, axes))
    devs = jax.devices()[:4]
    with pytest.raises(ValueError, match=match.split(",")[0].replace("-1", ".1")):
        jmake_mesh(axes, devices=devs)


def test_make_mesh_outside_ranks_raises():
    with pytest.raises(RuntimeError, match="inside ranks"):
        pmesh.make_mesh([("dp", 1)], devices=["cpu"])


def test_trial_devices_on_the_cpu(monkeypatch):
    monkeypatch.delenv("MTPU_ASSIGNED_CHIPS", raising=False)
    assert pmesh.trial_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv("MTPU_ASSIGNED_CHIPS", "4,5,6,7")
    assert pmesh.trial_devices("cpu") == [torch.device("cpu")] * 4


def test_trial_devices_rejects_duplicate_ids(monkeypatch):
    monkeypatch.setenv("MTPU_ASSIGNED_CHIPS", "1,1,2")
    with pytest.raises(ValueError, match="repeats"):
        pmesh.trial_devices("cpu")


@pytest.fixture
def eight_gpus(monkeypatch):
    """``torch.cuda`` seen as eight visible GPUs (trial_devices only maps ids)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)


def test_trial_devices_respects_assignment(monkeypatch, eight_gpus):
    monkeypatch.setenv("MTPU_ASSIGNED_CHIPS", "4,5,6,7")
    assert [d.index for d in pmesh.trial_devices()] == [4, 5, 6, 7]
    monkeypatch.delenv("MTPU_ASSIGNED_CHIPS")
    assert len(pmesh.trial_devices()) == 8


def test_trial_devices_rejects_out_of_range_ids(monkeypatch, eight_gpus):
    # never modulo-wrap onto a device already in the mesh
    monkeypatch.setenv("MTPU_ASSIGNED_CHIPS", "100,101")
    with pytest.raises(ValueError, match="exceed"):
        pmesh.trial_devices()


def test_trial_devices_takes_a_renumbered_block_whole(monkeypatch):
    # chip_env's CUDA_VISIBLE_DEVICES holds exactly the block: ids 6,7 are
    # the two visible GPUs 0, 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("MTPU_ASSIGNED_CHIPS", "6,7")
    assert [d.index for d in pmesh.trial_devices()] == [0, 1]


def test_trial_devices_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.trial_devices()


def test_active_mesh_context():
    assert pmesh.active_mesh() is None
    marker = object()
    with pmesh.use_mesh(marker) as entered:
        assert entered is marker and pmesh.active_mesh() is marker
    assert pmesh.active_mesh() is None


def test_shard_batch_places_on_dp(pool):
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    got = pool.run(legs.batch_rows, [("dp", 2), ("tp", 2)], x)
    rows = [g[0] for g in got]
    np.testing.assert_array_equal(rows[0].numpy(), x[:4])
    np.testing.assert_array_equal(rows[1].numpy(), x[:4])   # tp ranks hold the same rows
    np.testing.assert_array_equal(rows[3].numpy(), x[4:])
    assert all(g[1] == ("dp",) for g in got)               # the reference's P("dp")
    assert all(np.array_equal(g[2].numpy(), x) for g in got)
    assert pool.run(legs.batch_rows, [("tp", 4)], x)[0][1] == ()


@pytest.mark.parametrize("axes", [[("dp", 2), ("tp", 2)], [("ep", 2), ("tp", 2)]],
                         ids=["dp2-tp2", "ep2-tp2"])
def test_shard_params_match_the_references_shards(pool, axes):
    """Each rank's ``shard_params`` slice equals the device shard of the
    reference's ``init_sharded`` parameters on a CPU mesh of the same shape
    (the shard's flax tree through ``params_from_flax``)."""
    hp = {"d_model": 64, "n_heads": 4, "n_layers": 1, "d_ff": 128, "vocab": 53,
          "n_experts": 4 if axes[0][0] == "ep" else 0}
    jmesh = jmake_mesh(axes, devices=jax.devices()[:4])
    model = jt.make_model(hp)
    with jmesh:
        params, _, _ = jt.init_sharded(model, jmesh, optax.adam(1e-3), (4, 8))
    full = tt.params_from_flax(jax.tree.map(np.asarray, nn.meta.unbox(params)))
    shards = pool.run(legs.params_shards, axes, {k: v.numpy() for k, v in full.items()})
    devices = list(jmesh.devices.flat)
    for r, dev in enumerate(devices):
        # the reference's own shard on device r, converted like a whole tree
        def on(arr, dev=dev):
            return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)
        mine = tt.params_from_flax(jax.tree.map(on, nn.meta.unbox(params)))
        assert set(mine) == set(shards[r])
        tp_index = r % 2   # tp is the inner axis of both meshes
        for name, want in mine.items():
            got = shards[r][name].numpy()
            if got.shape != want.shape:
                # a column-split layer's bias: the reference replicates it (its
                # partition spec names the kernel only) and each device adds
                # its heads' part; the port's rank holds that part
                assert name.endswith(("q.bias", "k.bias", "v.bias", "wi.bias")), name
                want = want.reshape(2, -1)[tp_index]
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert shards[0]["enc.0.self_attn.q.weight"].shape[0] == 64 // 2


def test_pod_agree(pool):
    axes = [("dp", 2), ("tp", 2)]
    assert pool.run(legs.agree, axes, [False] * 4) == [False] * 4
    assert pool.run(legs.agree, axes, [False, False, True, False]) == [True] * 4


def test_run_signaled_runs_to_max_steps_without_signal(pool):
    got = pool.run(legs.signaled, [("dp", 4)], -1, 0, 10, 4)
    assert got == [(10, 10, False)] * 4


def test_run_signaled_stops_every_rank_at_the_chunk_boundary(pool):
    # rank 2 alone wants to stop, mid-chunk; every rank notices at the next check
    got = pool.run(legs.signaled, [("dp", 2), ("tp", 2)], 2, 6, 100, 4)
    assert got == [(8, 8, True)] * 4


def test_run_signaled_rejects_bad_check_every(pool):
    assert all("check_every" in e for e in pool.run(legs.signaled_bad, [("dp", 4)]))


def test_run_signaled_carries_tensor_state(pool):
    assert pool.run(legs.signaled_tensor, [("dp", 4)]) == [(32.0, 5, False)] * 4


def test_a_rank_that_raises_fails_the_call_with_its_traceback(pool):
    with pytest.raises(ValueError) as info:
        pool.run(legs.mesh_facts, [("dp", 3)])
    assert isinstance(info.value.__cause__, RankError)
    assert "rank 0 of 4 failed" in str(info.value.__cause__)
    assert pool.alive   # every rank raised before any collective: still usable


def test_a_call_that_hangs_times_out_and_closes_the_pool():
    with RankPool(["cpu"] * 2, timeout_s=20) as p:
        with pytest.raises(RankError, match="did not answer"):
            p.run(legs.sleep, 30, timeout_s=1.0)
        assert not p.alive


def test_backend_choice():
    assert launch.backend_for(["cpu", "cpu"]) == "gloo"
    assert launch.backend_for(["cuda:0", "cuda:0"]) == "gloo"   # ranks share a GPU
    assert launch.backend_for(["cuda:0", "cuda:1"]) == "nccl"


def test_moe_capacity_and_balance_are_global(pool):
    """dp 2 × ep 2: the layer's output, dropped fraction and balance loss
    equal the reference's on the whole batch, where capacity per dp half
    would drop other items."""
    hp = {"d_model": 32, "d_ff": 64, "n_experts": 4, "capacity_factor": 1.0}
    layer = jmoe.MoEFeedForward(32, 64, 4, capacity_factor=1.0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    x[2:] += 2.0 * rng.standard_normal(32).astype(np.float32)   # the second half routes alike
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    y, stats = layer.apply(variables, jnp.asarray(x), train=False,
                           mutable=["aux_loss", "moe_stats"])
    want_drop = float(stats["moe_stats"]["dropped_fraction"][0])
    want_bal = float(stats["aux_loss"]["moe_balance"][0])
    p = jax.tree.map(np.asarray, nn.meta.unbox(variables["params"]))
    state = {"router.weight": p["router"]["kernel"].T.copy(),
             "router.bias": np.array(p["router"]["bias"]), "wi": np.array(p["wi"]),
             "wo": np.array(p["wo"])}
    parts = pool.run(legs.moe_layer, [("dp", 2), ("ep", 2)], hp, state, x)
    got = np.concatenate([parts[0]["y"].numpy(), parts[2]["y"].numpy()], 0)
    np.testing.assert_allclose(got, np.asarray(y), atol=3e-2 * np.abs(np.asarray(y)).max())
    assert all(r["dropped"] == pytest.approx(want_drop, abs=1e-7) for r in parts)
    assert all(r["balance"] == pytest.approx(want_bal, rel=1e-5) for r in parts)
    assert want_drop > 0
    # the same layer on one rank per dp half: other drops
    local = MoEFeedForward(32, 64, 4, capacity_factor=1.0)
    local.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    halves = []
    for half in (x[:2], x[2:]):
        aux = {}
        local(torch.from_numpy(half), aux=aux)
        halves.append(float(aux["moe_stats"][0]))
    assert np.mean(halves) != pytest.approx(want_drop, abs=1e-6)
