"""Remat (a ``torch.autograd.Function`` per layer) in the port's LM and Transformer.

The reference rematerializes with ``nn.remat``, whose recompute draws the
same dropout because flax's keys are pure. The port's draws advance
generators, so each layer's masks and attention seeds are taken before the
recomputed region (``LayerDraws``) and replayed in it. Held here, on the
CPU at dropout 0.1: remat on gives the same loss and gradients as remat off
(bit for bit: the recompute runs the same operations on the same inputs),
dense and MoE, for both model families, with ``Draws`` and with
``GivenDraws`` (whose masks a fresh draw in the recompute would run past);
K1 runs twice per layer and train step under remat, K2 and K3 once; the
MoE statistics leave the checkpoint once per layer.
"""

import numpy as np
import pytest
import torch

from metaopt_tpu_torch.models import lm, transformer as tt
from metaopt_tpu_torch.ops import attention as att

SMALL = dict(vocab=64, d_model=64, n_heads=1, n_layers=2, d_ff=64, dropout=0.1, max_len=32)
MOE = [dict(), dict(n_experts=4), dict(n_experts=4, router_top_k=2),
       dict(n_experts=4, capacity_factor=0.0, router_top_k=2)]
IDS = ["dense", "moe-top1", "moe-top2", "moe-dense-oracle"]


def lm_tokens(seed=0):
    toks = np.random.default_rng(seed).integers(2, 64, (3, 17))
    toks[2, 13:] = 0
    return torch.from_numpy(toks)


def grads_and_loss(model, loss_of):
    model.zero_grad()
    stats = {}
    loss = loss_of(model, stats)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}, stats


def assert_same(a, b):
    (la, ga, sa), (lb, gb, sb) = a, b
    assert torch.equal(la, lb), (float(la), float(lb))
    assert ga.keys() == gb.keys()
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name
    assert sa.keys() == sb.keys()
    for key in ("aux_loss", "moe_stats"):
        assert [float(x) for x in sa.get(key, [])] == [float(x) for x in sb.get(key, [])]


def pair(make, hp, moe):
    """The same weights in a model with remat off and one with it on."""
    off = make({**hp, **moe, "remat": False}).init_like_flax(torch.Generator().manual_seed(1))
    on = make({**hp, **moe, "remat": True})
    on.load_state_dict(off.state_dict())
    assert on.remat and not off.remat
    return off, on


@pytest.mark.parametrize("moe", MOE, ids=IDS)
def test_lm_remat_equals_no_remat_at_dropout(moe):
    off, on = pair(lm.make_lm, SMALL, moe)
    toks = lm_tokens()
    runs = [grads_and_loss(m, lambda m, st: lm.lm_loss_fn(m, toks, tt.Draws(3, 7, "cpu"),
                                                          stats=st))
            for m in (off, on)]
    assert_same(*runs)
    if moe:
        assert len(runs[1][2]["aux_loss"]) == 2   # one per layer, not one per run
    # the draws are live: another step's draws give another loss
    other = lm.lm_loss_fn(off, toks, tt.Draws(3, 8, "cpu"))
    assert not torch.equal(other.detach(), runs[0][0])


@pytest.mark.parametrize("moe", MOE[:3], ids=IDS[:3])
def test_transformer_remat_equals_no_remat_at_dropout(moe):
    off, on = pair(tt.make_model, dict(SMALL, n_layers=1), moe)
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.integers(2, 64, (2, 12)))
    tgt = torch.from_numpy(rng.integers(2, 64, (2, 12)))
    runs = [grads_and_loss(m, lambda m, st: tt.loss_fn(m, (src, tgt), tt.Draws(0, 2, "cpu"),
                                                       stats=st))
            for m in (off, on)]
    assert_same(*runs)


def test_given_draws_are_consumed_once_under_remat():
    """One mask per layer is given; the recompute replays the layer's own
    instead of asking ``GivenDraws`` for more (which would raise)."""
    off, on = pair(lm.make_lm, SMALL, {})
    toks = lm_tokens(1)
    rng = np.random.default_rng(4)
    masks = [rng.random((3, 16, 64)) < 0.9 for _ in range(2)]
    runs = [grads_and_loss(m, lambda m, st: lm.lm_loss_fn(
        m, toks, tt.GivenDraws(masks, attention_seed=5, device="cpu"))) for m in (off, on)]
    assert_same(*runs)


def test_k1_runs_twice_per_layer_under_remat(monkeypatch):
    calls = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    for name in calls:
        real = getattr(att, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(att, name, counting)
    toks = lm_tokens(2)
    for remat, want_fwd in ((False, 2), (True, 4)):
        for k in calls:
            calls[k] = 0
        model = lm.make_lm({**SMALL, "remat": remat}).init_like_flax(
            torch.Generator().manual_seed(0))
        lm.lm_loss_fn(model, toks, tt.Draws(0, 0, "cpu")).backward()
        assert calls == {"flash_fwd": want_fwd, "flash_bwd_dkv": 2, "flash_bwd_dq": 2}, remat


def test_layer_draws_replay_in_order_and_check_shapes():
    draws = tt.Draws(0, 0, "cpu")
    fixed = tt.LayerDraws.take(draws, 2, [(2, 3), (4,)], 0.9)
    for _ in range(2):
        run = fixed.replay()
        a, b = run.attention_draw(), run.attention_draw()
        assert a != b and set(a) == {"philox"}
        m1, m2 = run.ffn_keep((2, 3), 0.9), run.ffn_keep((4,), 0.9)
        assert m1.shape == (2, 3) and m2.shape == (4,)
    assert fixed.replay().attention_draw() == a
    with pytest.raises(ValueError, match="shape"):
        fixed.replay().ffn_keep((3, 2), 0.9)


def test_a_remat_train_step_imports_no_torch_dynamo():
    """Remat is the port's own ``torch.autograd.Function``:
    ``torch.utils.checkpoint`` imports ``torch._dynamo`` at its first call
    (~11 s per fresh process on the card's host), and the reference's
    ``nn.remat`` costs nothing at a trial's start. Dense and MoE, both model
    families, forward and backward."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import torch\n"
        "from metaopt_tpu_torch.models import lm, transformer as tt\n"
        "small = dict(vocab=64, d_model=64, n_heads=1, n_layers=2, d_ff=64, dropout=0.1,\n"
        "             max_len=32, remat=True)\n"
        "toks = torch.randint(2, 64, (2, 9), generator=torch.Generator().manual_seed(0))\n"
        "for moe in ({}, {'n_experts': 4}):\n"
        "    m = lm.make_lm({**small, **moe}).init_like_flax(torch.Generator().manual_seed(0))\n"
        "    lm.lm_loss_fn(m, toks, tt.Draws(0, 0, 'cpu')).backward()\n"
        "tt.train_and_eval({'lr': 1e-3, 'dropout': 0.1, 'd_model': 64, 'n_heads': 1,\n"
        "                   'n_layers': 1, 'd_ff': 64, 'vocab': 64, 'remat': True}, steps=2,\n"
        "                  n_train=8, batch_size=4, seq_len=8, device='cpu')\n"
        "print('torch._dynamo' in sys.modules)\n")
    repo = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo, env={**os.environ, "PYTHONPATH": repo,
                                                     "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"
