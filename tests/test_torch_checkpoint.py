"""Trial checkpoints of the port (``metaopt_tpu_torch/models/checkpoint.py``)
and the Transformer's ``train_and_eval(restore_dir=..., save_dir=...)``.

The reference saves one orbax directory per tree; the port saves a
trial's trees in one ``torch.save`` file, published by rename. Held here:
the round trip is exact; training 2k steps equals training k, saving,
restoring and training k more (dropout 0, one batch, one optimizer
schedule); a temporary file left by an interrupted save is not a
checkpoint; a save cut short after a restore leaves the earlier
parameters and optimizer state together; a leaf-count mismatch raises the
reference's error; ``train_and_eval`` saves and restores the reference's
``params`` and ``opt_state`` trees.
"""

import os

import numpy as np
import pytest
import torch

from metaopt_tpu_torch.models import checkpoint as ck
from metaopt_tpu_torch.models import transformer as tt

SMALL = dict(vocab=64, d_model=64, n_heads=1, n_layers=1, d_ff=64, dropout=0.0)


def test_round_trip_is_exact(tmp_path):
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(3, 5, generator=gen), torch.tensor(7, dtype=torch.int64),
              torch.randn(4, generator=gen).bfloat16(), torch.zeros(0)]
    path = str(tmp_path / "trial" / "state")
    ck.save_state(path, {"params": leaves, "opt_state": leaves[:1]})
    assert ck.has_state(path)
    back = ck.restore_state(path, {"params": [torch.empty_like(t) for t in leaves],
                                   "opt_state": [torch.empty(3, 5)]})
    for a, b in zip(leaves + leaves[:1], back["params"] + back["opt_state"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the leaves are named by index, as the reference names them
    payload = torch.load(path, weights_only=True)
    assert sorted(payload) == ["opt_state/00000", "params/00000", "params/00001",
                               "params/00002", "params/00003"]


def test_a_save_replaces_the_earlier_checkpoint(tmp_path):
    path = str(tmp_path / "state")
    ck.save_state(path, {"opt_state": [torch.ones(2)]})
    ck.save_state(path, {"opt_state": [torch.full((2,), 3.0)]})
    back = ck.restore_state(path, {"opt_state": [torch.empty(2)]})
    assert torch.equal(back["opt_state"][0], torch.full((2,), 3.0))
    assert os.listdir(tmp_path) == ["state"]


def test_an_unrenamed_temporary_reads_as_no_state(tmp_path, monkeypatch):
    """A save cut before its rename leaves only a temporary file: it is not
    a checkpoint (the reference's ``has_state`` accepts any non-empty
    directory, so also a half-written one)."""
    trial = tmp_path / "trial"

    def crash(src, dst):
        raise OSError("interrupted before the rename")

    monkeypatch.setattr(ck.os, "replace", crash)
    with pytest.raises(OSError):
        ck.save_state(str(trial / tt.CKPT_FILE), {"params": [torch.ones(3)]})
    monkeypatch.undo()
    assert not ck.has_state(str(trial / tt.CKPT_FILE))
    assert not os.listdir(trial)  # the failed save removed its temporary
    # a temporary left behind (a killed process cannot clean up) is no state either
    (trial / (ck._TMP_PREFIX + tt.CKPT_FILE + ".x")).write_bytes(b"half")
    assert not ck.has_state(str(trial / tt.CKPT_FILE))
    assert not ck.has_state(str(trial / (ck._TMP_PREFIX + tt.CKPT_FILE + ".x")))
    model = tt.make_model(SMALL)
    opt = tt.trial_setup({}, model.parameters(), 4)
    assert tt.maybe_restore(str(trial), model, opt) is False


def test_leaf_count_mismatch_raises(tmp_path):
    path = str(tmp_path / "state")
    ck.save_state(path, {"params": [torch.ones(2), torch.ones(3)]})
    with pytest.raises(ValueError, match="has 2 leaves, expected 3"):
        ck.restore_state(path, {"params": [torch.ones(2), torch.ones(3), torch.ones(1)]})
    with pytest.raises(ValueError, match="has 0 leaves, expected 1"):
        ck.restore_state(path, {"opt_state": [torch.ones(1)]})
    with pytest.raises(ValueError, match="shape"):
        ck.restore_state(path, {"params": [torch.ones(2), torch.ones(4)]})


def _train(model, opt, batch, steps):
    step = tt.make_train_step(model, opt)
    return [float(step(batch, tt.Draws(0, i, "cpu"))) for i in range(steps)]


def test_resuming_from_a_checkpoint_equals_training_straight_through(tmp_path):
    """2k steps straight equal k steps, a save, a restore into a fresh model
    and optimizer, and k more: parameters, moments and the schedule's
    position all come back."""
    k = 4
    hp = {"lr": 3e-3, "warmup": 2, "weight_decay": 0.01}
    src, tgt = tt.synthetic_seq2seq(8, 12, SMALL["vocab"], seed=1, device="cpu")

    def fresh():
        model = tt.make_model(SMALL).init_like_flax(torch.Generator().manual_seed(0))
        return model, tt.trial_setup(hp, model.parameters(), 2 * k)

    model, opt = fresh()
    straight = _train(model, opt, (src, tgt), 2 * k)

    model1, opt1 = fresh()
    first = _train(model1, opt1, (src, tgt), k)
    ck.save_state(str(tmp_path / tt.CKPT_FILE),
                  {"params": list(model1.parameters()), "opt_state": opt1.state_leaves()})
    model2, opt2 = fresh()
    assert tt.maybe_restore(str(tmp_path), model2, opt2) is True
    assert opt2.updates == k
    second = _train(model2, opt2, (src, tgt), k)

    assert first + second == straight
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(opt.state_leaves(), opt2.state_leaves()):
        assert torch.equal(a, b)


def test_train_and_eval_saves_and_restores_under_the_reference_names(tmp_path):
    kw = dict(steps=3, n_train=16, batch_size=8, seq_len=8, device="cpu")
    hp = {"lr": 1e-3, "warmup": 1, **SMALL, "dropout": 0.1}
    rep = {}
    tt.train_and_eval(hp, save_dir=str(tmp_path / "a"), report=rep, **kw)
    assert rep["restored"] is False
    assert os.listdir(tmp_path / "a") == [tt.CKPT_FILE]
    rep2 = {}
    tt.train_and_eval(hp, restore_dir=str(tmp_path / "a"), save_dir=str(tmp_path / "b"),
                      report=rep2, **kw)
    assert rep2["restored"] is True
    payload = torch.load(tmp_path / "b" / tt.CKPT_FILE, weights_only=True)
    assert {k.split("/")[0] for k in payload} == {"params", "opt_state"}
    assert int(payload["opt_state/00000"]) == 6  # the update count carries over: 3 + 3
    # an empty directory (a fresh trial's own) restores nothing
    os.makedirs(tmp_path / "empty")
    rep3 = {}
    loss = tt.train_and_eval(hp, restore_dir=str(tmp_path / "empty"), report=rep3, **kw)
    assert rep3["restored"] is False and np.isfinite(loss)


@pytest.mark.parametrize("cut", ["mid_write", "before_rename"])
def test_a_save_cut_short_after_a_restore_keeps_the_earlier_pair(tmp_path, monkeypatch, cut):
    """A re-run trial restores its own checkpoint, trains, and dies while
    saving into the same directory: after the params tree was written but
    before the opt_state tree (``mid_write``), or after both but before the
    rename. The directory still holds the first run's parameters with the
    first run's optimizer state, never new parameters beside old moments."""
    kw = dict(steps=3, n_train=16, batch_size=8, seq_len=8, device="cpu")
    hp = {"lr": 1e-3, "warmup": 1, **SMALL}
    trial = str(tmp_path / "trial")
    tt.train_and_eval(hp, save_dir=trial, **kw)
    first = torch.load(os.path.join(trial, tt.CKPT_FILE), weights_only=True)

    if cut == "mid_write":
        def crash(payload, f):
            f.write(b"params tree written, opt_state tree not yet")
            raise OSError("killed between the params and the opt_state tree")
        monkeypatch.setattr(ck.torch, "save", crash)
    else:
        def crash(src, dst):
            raise OSError("killed before the rename")
        monkeypatch.setattr(ck.os, "replace", crash)
    rep = {}
    with pytest.raises(OSError, match="killed"):
        tt.train_and_eval(hp, restore_dir=trial, save_dir=trial, report=rep, **kw)
    monkeypatch.undo()
    assert os.listdir(trial) == [tt.CKPT_FILE]

    model = tt.make_model(hp)
    opt = tt.trial_setup(hp, model.parameters(), kw["steps"])
    assert tt.maybe_restore(trial, model, opt) is True
    assert opt.updates == 3  # not 6: the second run's update never landed
    leaves = list(model.parameters()) + opt.state_leaves()
    want = [first[k] for k in sorted(first) if k.startswith("params/")] + \
        [first[k] for k in sorted(first) if k.startswith("opt_state/")]
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert torch.equal(a, b)
