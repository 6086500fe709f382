"""The training entry points on meshes, and a tp 2 trial through the port's
CLI, on the CPU.

``train_lm``/``train_and_eval`` launch their own ranks from the trial's
block (two CPU ranks for ``MTPU_ASSIGNED_CHIPS=0,1``) and equal the
one-rank run; inside ranks they take ``mesh=`` (the reference's
``test_sp_train_step_runs``: tp 2 × sp 2 at dropout 0.1 on four ranks;
its ``test_tp_sp_ep_in_one_jit``: a tp 2 × ep 2 MoE Transformer, whose
losses equal the one-rank run's within 2e-3, the MoE Transformer's
one-rank run held to the reference by ``tests/test_torch_moe.py``).

``hunt --n-chips 2`` on a two-GPU slot (``MTPU_SLICE_CHIPS=2``: the
executor hands each trial a block of two chips, ``MTPU_ASSIGNED_CHIPS``)
with ``transformer_wmt.py --device cpu --tp 2``: each trial process
launches its two ranks (one per chip of its block; here two CPU ranks) on
a dp 1 × tp 2 mesh, trains, and reports rank 0's loss. Two random-search
trials, both completed, finite, and each ran on the mesh (its ``mesh``
statistic). The executor is the one-device path's: a trial sees its block
and launches its own ranks.
"""

import math
import tempfile
from pathlib import Path

import numpy as np
import pytest

import torch_mesh_legs as legs
from metaopt_tpu_torch.cli import main
from metaopt_tpu_torch.ledger import FileLedger
from metaopt_tpu_torch.models import lm, transformer as tt
from metaopt_tpu_torch.parallel.launch import RankPool

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "metaopt_tpu_torch" / "examples"


def test_tp2_trials_through_hunt_n_chips_2(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_SLICE_CHIPS", "2")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # each rank's torch
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    led = tmp_path / "ledger"
    assert main(["hunt", "-n", "mesh", "--n-chips", "2", "--max-trials", "2",
                 "--ledger", f"file:{led}", str(EXAMPLES / "transformer_wmt.py"),
                 "--tp", "2", "--d-model", "128", "--n-layers", "1", "--d-ff", "64",
                 "--steps-per-epoch", "2", "--device=cpu",
                 "--lr~loguniform(1e-4, 5e-3)"]) == 0
    trials = FileLedger(str(led)).fetch("mesh")
    assert len(trials) == 2 and all(t.status == "completed" for t in trials)
    for t in trials:
        assert math.isfinite(t.objective)
        stats = {r.name: r.value for r in t.results if r.type == "statistic"}
        assert stats["mesh"] == "dp=1,tp=2" and stats["device"] == "cpu"


HP = dict(vocab=61, d_model=64, n_heads=2, n_layers=1, d_ff=64, dropout=0.0, max_len=32,
          lr=1e-3, warmup=1)


@pytest.fixture(scope="module")
def pool():
    with RankPool(["cpu"] * 4, timeout_s=80) as p:
        yield p


def test_training_entry_points_launch_their_ranks(monkeypatch):
    """``train_and_eval``/``train_lm`` at tp 2 on a two-chip CPU block
    launch two ranks and return rank 0's loss, equal to the one-rank run."""
    hp = dict(HP)
    kw = dict(n_train=8, batch_size=4, seq_len=8, steps=2, device="cpu")
    monkeypatch.delenv("MTPU_ASSIGNED_CHIPS", raising=False)
    one = {}
    lm.train_lm(hp, report=one, **kw)
    monkeypatch.setenv("MTPU_ASSIGNED_CHIPS", "0,1")
    two = {}
    lm.train_lm(hp, tp=2, report=two, **kw)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=2e-3)
    with pytest.raises(ValueError, match="not divisible by fixed axes 4"):
        tt.train_and_eval(hp, tp=4, **kw)


def test_sp_train_step_runs(pool):
    """The reference's ``test_sp_train_step_runs``: tp 2 × sp 2 at dropout
    0.1 trains to a finite loss."""
    hp = {"d_model": 64, "n_heads": 2, "n_layers": 1, "d_ff": 64, "vocab": 97, "lr": 1e-3,
          "dropout": 0.1}
    kw = dict(n_train=32, batch_size=8, seq_len=16, steps=2)
    losses = pool.run(legs.train_on_mesh, [("tp", 2), ("sp", 2)], "tfm", hp, kw)
    assert all(np.isfinite(x).all() and x[-1] > 0 for x in losses)


def test_tp_sp_ep_in_one_mesh(pool):
    """The reference's ``test_tp_sp_ep_in_one_jit`` at 4 ranks: a tp 2 ×
    ep 2 MoE Transformer trains, its losses the one-rank run's (2e-3);
    ``test_sp_train_step_runs`` composes sp with tp, and the LM's ep2 case
    of ``test_train_steps_match_the_reference`` ep with dp."""
    hp = dict(HP, d_model=128, n_heads=4, n_experts=2)
    kw = dict(n_train=16, batch_size=4, seq_len=16, steps=2)
    one = {}
    tt.train_and_eval(hp, device="cpu", report=one, **kw)
    losses = pool.run(legs.train_on_mesh, [("tp", 2), ("ep", 2)], "tfm", hp, kw)[0]
    np.testing.assert_allclose(losses, one["losses"], rtol=2e-3)


def test_remat_replays_dropout_under_a_mesh(pool):
    """Remat's per-layer Function recomputes each layer in the backward on
    the layer's own draws: on dp 2 × tp 2 at dropout 0.1 the LM trains to
    the same losses with and without it (each rank slices the same whole
    masks twice)."""
    hp = dict(HP, d_model=128, n_heads=4, dropout=0.1)
    kw = dict(n_train=8, batch_size=4, seq_len=8, steps=2)
    plain = pool.run(legs.train_on_mesh, [("dp", 2), ("tp", 2)], "lm", hp, kw)[0]
    remat = pool.run(legs.train_on_mesh, [("dp", 2), ("tp", 2)], "lm", dict(hp, remat=True),
                     kw)[0]
    assert remat == plain and all(np.isfinite(plain))
