"""The port's ResNet (BASELINE config 3's model) against the JAX package's.

A flax ``ResNet`` is initialized by flax, its batch-norm scales, biases
and running statistics are overwritten with seeded random values (flax's
init zeroes each block's last scale, so that every residual branch would
output 0 and only the stem, the projections and the head would reach the
logits), converted with ``params_from_flax`` and fed the same numpy batch
in both packages. Both run their convolutions in bf16 (the reference
hard-codes it; the port keeps it on every device), so forward, loss and
the batch statistics are held at the bf16 bound 3e-2 + 3e-2·|ref|.

The loss gradient is held with full-precision convolutions: f32 in the
reference (its ``jnp.bfloat16`` seen as ``float32`` through its module's
``jnp`` name) and f64 in the port (``_CONV_DTYPE``; PyTorch's CPU f32
backward of a strided 1×1 convolution on a channels-last input crashes).
In bf16 a single bottleneck's training-mode gradient already differs from
the reference's by up to 10% of its largest entry, and the whole depth-50
gradient from the f64 one by ~30%, in either package. The batch-norm
layer alone (f32) is held at 1e-5 and the Nesterov SGD step against optax
(f32) at 1e-6. The reference runs under ``jax.jit`` in module-scoped
fixtures.
"""

import math
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from metaopt_tpu.models import resnet as jr
from metaopt_tpu_torch.models import resnet as tr

BF16 = (3e-2, 3e-2)   # atol, rtol: the repo's bf16 bound
F32 = (1e-4, 1e-4)    # atol, rtol with full-precision convolutions
REF_PARAMS_50 = 23_520_842


def close(got, want, atol, rtol):
    """max |got - want| - (atol + rtol |want|): <= 0 within the bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


def flax_model(depth, width, hw, batch, seed=0):
    rng = np.random.default_rng(seed)
    # a mean of 1, so that the stem's batch mean (and the running mean a
    # wrong momentum would misplace) stands clear of the bf16 bound
    x = (rng.normal(size=(batch, hw, hw, 3)) + 1.0).astype(np.float32)
    y = rng.integers(0, 10, batch)
    model = jr.ResNet(depth=depth, width=width)
    variables = jax.jit(partial(model.init, train=False))(jax.random.PRNGKey(seed),
                                                          jnp.asarray(x[:1]))
    return model, variables, x, y


def randomize_norms(variables, seed):
    """``variables`` with every batch norm's scale, bias, running mean and
    running variance drawn from ``seed``. A block's last scale is drawn
    from U(0.1, 0.3), every other from U(0.5, 1.5): with scales near 1 in
    every block the depth-50 network's bf16 rounding grows past the bf16
    bound in the reference itself (train logits 0.6 apart from f32)."""
    rng = np.random.default_rng(seed)

    def walk(params, last):
        p, s = {}, {}
        for name, sub in params.items():
            if name.startswith("BatchNorm_"):
                c = np.shape(sub["scale"])
                lo, hi = (0.1, 0.3) if name == last else (0.5, 1.5)
                p[name] = {"scale": rng.uniform(lo, hi, c).astype(np.float32),
                           "bias": rng.normal(0.0, 0.1, c).astype(np.float32)}
                s[name] = {"mean": rng.normal(0.0, 0.1, c).astype(np.float32),
                           "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
            elif name.startswith(("Bottleneck_", "BasicBlock_")):
                p[name], s[name] = walk(sub, "BatchNorm_2" if name.startswith("Bottleneck_")
                                        else "BatchNorm_1")
            else:
                p[name] = sub
        return p, s

    params, stats = walk(variables["params"], None)
    return {"params": params, "batch_stats": stats}


class _F32Convs:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``: the reference's
    convolutions in f32, its own module untouched."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def ref_outputs(model, variables, x, y, grad=False):
    """Eval logits, train logits, train loss, the batch_stats after one
    training forward and (with ``grad``) the loss gradient, from one
    jitted call."""

    @jax.jit
    def run(v, x, y):
        def loss_fn(params):
            logits, state = model.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                        train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
            return loss, (logits, state["batch_stats"])

        if grad:
            (loss, (logits, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                v["params"])
        else:
            (loss, (logits, stats)), grads = loss_fn(v["params"]), None
        return model.apply(v, x, train=False), logits, loss, stats, grads

    return jax.tree.map(np.asarray, run(variables, jnp.asarray(x), jnp.asarray(y)))


def port_model(depth, width, variables):
    model = tr.ResNet(depth=depth, width=width)
    model.load_state_dict(tr.params_from_flax(variables["params"],
                                              variables["batch_stats"]), strict=True)
    return model


def port_outputs(depth, variables, x, y):
    """The port's counterpart of :func:`ref_outputs` (gradients always)."""
    model = port_model(depth, 8, variables)
    x = torch.from_numpy(x)
    with torch.no_grad():
        eval_logits = model(x, train=False)
    train_logits = model(x, train=True)
    loss = F.cross_entropy(train_logits, torch.from_numpy(y))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return eval_logits, train_logits.detach(), loss.detach(), model.state_dict(), grads


def batch_statistics(before, after):
    """Each norm's batch mean and batch variance, recovered from its running
    averages before and after one training forward with flax's momentum
    (0.99 in the stem, 0.9 in the blocks): (after - m·before) / (1 - m). The
    running averages themselves carry only 1 - m of the batch's."""
    out = {}
    for k, old in before.items():
        if k.endswith(("running_mean", "running_var")):
            m = 0.99 if k.startswith("stem_bn.") else 0.9
            out[k] = (np.asarray(after[k], np.float64) - m * np.asarray(old, np.float64)) / (1 - m)
    return out


@pytest.fixture(scope="module", params=[50, 18], ids=["bottleneck-50", "basic-18"])
def pair(request):
    depth = request.param
    model, variables, x, y = flax_model(depth, width=8, hw=16, batch=4)
    variables = randomize_norms(variables, seed=5)
    ref = ref_outputs(model, variables, x, y)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "jnp", _F32Convs())
        ref32 = ref_outputs(model, variables, x, y, grad=True)
    return dict(depth=depth, variables=variables, x=x, y=y, ref=ref, ref32=ref32)


def test_params_from_flax_covers_every_leaf_at_full_width():
    model = jr.ResNet(depth=50)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 32, 32, 3)), train=False))
    leaves = jax.tree.leaves(shapes["params"])
    assert len(leaves) == 161
    assert sum(int(np.prod(leaf.shape)) for leaf in leaves) == REF_PARAMS_50
    # distinct values per leaf: a leaf mapped twice or not at all shows
    counter = iter(range(1, 10 ** 6))
    variables = jax.tree.map(lambda s: np.full(s.shape, next(counter), np.float32), shapes)
    sd = tr.params_from_flax(variables["params"], variables["batch_stats"])
    port = tr.ResNet(depth=50)
    want = port.state_dict()
    assert set(sd) == set(want)
    assert all(sd[k].shape == want[k].shape for k in want)
    n_stats = len(jax.tree.leaves(shapes["batch_stats"]))
    assert len(sd) == 161 + n_stats
    assert len({float(v.flatten()[0]) for v in sd.values()}) == 161 + n_stats
    assert sum(p.numel() for p in port.parameters()) == REF_PARAMS_50
    assert len(list(port.parameters())) == 161


def test_param_count_of_every_depth_matches_the_reference():
    for depth in (18, 50):
        shapes = jax.eval_shape(lambda: jr.ResNet(depth=depth, width=16).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False))
        want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes["params"]))
        assert sum(p.numel() for p in tr.ResNet(depth=depth, width=16).parameters()) == want


def test_forward_and_loss_match_flax(pair):
    got_eval, got_train, got_loss, _, _ = port_outputs(pair["depth"], pair["variables"],
                                                       pair["x"], pair["y"])
    eval_logits, train_logits, loss, _, _ = pair["ref"]
    assert got_eval.dtype == got_train.dtype == torch.float32
    # measured (depth 50 / 18; logits up to 1.14 / 1.27): max |diff| eval
    # 1.8e-3 / 2.3e-3, train 1.7e-2 / 1.5e-2, loss 3.5e-3 / 1.5e-3, against
    # the bound 3e-2 + 3e-2|ref|
    assert close(got_eval, eval_logits, *BF16) <= 0
    assert close(got_train, train_logits, *BF16) <= 0
    assert close(float(got_loss), float(loss), *BF16) <= 0
    # every block's body reaches the logits: with each block's last scale
    # zeroed (flax's init) they move by 0.11 in eval and 0.53 in training
    model = port_model(pair["depth"], 8, pair["variables"])
    with torch.no_grad():
        for norm in model.modules():
            if isinstance(norm, tr.BatchNorm) and norm.zero_scale:
                norm.weight.zero_()
        assert close(model(torch.from_numpy(pair["x"]), train=False), eval_logits, *BF16) > 0
        assert close(model(torch.from_numpy(pair["x"]), train=True), train_logits, *BF16) > 0


def test_batch_stats_after_one_training_forward_match_flax(pair):
    variables = pair["variables"]
    _, _, _, after, _ = port_outputs(pair["depth"], variables, pair["x"], pair["y"])
    before = tr.params_from_flax(variables["params"], variables["batch_stats"])
    want = batch_statistics(before, tr.params_from_flax(variables["params"], pair["ref"][3]))
    got = batch_statistics(before, after)
    n_norms = sum(k.endswith("running_mean") for k in before)
    assert len(want) == len(got) == 2 * n_norms
    for k in want:  # measured: max |diff| 3.7e-2 / 5.4e-3, within the bound
        assert close(got[k], want[k], *BF16) <= 0, k
    # the stem's norm uses flax's default momentum 0.99; with 0.9 its running
    # mean would recover as 10·batch - 9·before, which this data shows
    old = before["stem_bn.running_mean"].numpy()
    wrong = 10 * want["stem_bn.running_mean"] - 9 * old
    assert close(wrong, want["stem_bn.running_mean"], *BF16) > 0


def test_full_precision_convolutions_match_flax_forward_stats_and_gradient(pair, monkeypatch):
    monkeypatch.setattr(tr, "_CONV_DTYPE", torch.float64)
    variables = pair["variables"]
    got_eval, got_train, got_loss, after, grads = port_outputs(
        pair["depth"], variables, pair["x"], pair["y"])
    eval_logits, train_logits, loss, stats, ref_grads = pair["ref32"]
    # measured (depth 50 / 18): max |diff| eval 1.5e-7 / 1.8e-7, train
    # 6.1e-6 / 3.4e-6, loss 2.4e-7 / 2.4e-7
    assert close(got_eval, eval_logits, *F32) <= 0
    assert close(got_train, train_logits, *F32) <= 0
    assert close(float(got_loss), float(loss), *F32) <= 0
    before = tr.params_from_flax(variables["params"], variables["batch_stats"])
    want = batch_statistics(before, tr.params_from_flax(variables["params"], stats))
    got = batch_statistics(before, after)
    for k in want:  # measured: 5.1e-6 of 1 + |ref|
        assert close(got[k], want[k], *F32) <= 0, k
    # the loss gradient of every parameter, through the custom batch norm,
    # F.pad's SAME padding and the projections, each leaf in units of its
    # largest entry; measured: worst leaf 1.7e-5 / 1.1e-5
    want = tr.params_from_flax(ref_grads, variables["batch_stats"])
    assert set(grads) == {k for k in want if not k.endswith(("running_mean", "running_var"))}
    for k, g in grads.items():
        scale = float(want[k].abs().max())
        assert scale > 0, k
        assert close(g / scale, want[k] / scale, *F32) <= 0, k


@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batch_norm_layer_matches_flax_in_f32(momentum):
    # batch 4 of 1x1 inputs with a large variance: the unbiased variance is
    # 4/3 of the biased one, so a running update of F.batch_norm's kind fails
    rng = np.random.default_rng(1)
    c = 16
    x = (rng.normal(size=(4, 1, 1, c)) * 30.0 + rng.normal(size=c) * 5.0).astype(np.float32)
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean0 = rng.normal(size=c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    bn = nn.BatchNorm(momentum=momentum, dtype=jnp.float32)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    port = tr.BatchNorm(c, momentum)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0)})
    for step in range(3):
        xs = x * (step + 1)
        y, upd = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs),
                          use_running_average=False, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = port(torch.from_numpy(xs).permute(0, 3, 1, 2), train=True)
        # measured: output 2.4e-7 absolute, running stats 6.8e-7 relative
        assert close(got.permute(0, 2, 3, 1).detach(), y, 1e-5, 1e-5) <= 0
        assert close(port.running_mean, stats["mean"], 1e-5, 1e-5) <= 0
        assert close(port.running_var, stats["var"], 1e-5, 1e-5) <= 0
    unbiased = np.var(x * 3, axis=(0, 1, 2), ddof=1)
    biased = np.var(x * 3, axis=(0, 1, 2))
    assert np.all(unbiased > biased * 1.3)  # the trap is visible at this size
    y = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                 use_running_average=True)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=False)
    assert close(got.permute(0, 2, 3, 1).detach(), y, 1e-5, 1e-5) <= 0


def test_strided_conv_pads_like_flax_same():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    conv = nn.Conv(6, (3, 3), strides=(2, 2), use_bias=False, dtype=jnp.bfloat16)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)), np.float32)
    port = torch.nn.Conv2d(4, 6, 3, stride=2, bias=False)
    kernel = np.asarray(variables["params"]["kernel"], np.float32)
    port.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tr._conv(port, xt).float().permute(0, 2, 3, 1)
        symmetric = F.conv2d(xt.bfloat16(), port.weight.bfloat16(), stride=2,
                             padding=1).float().permute(0, 2, 3, 1)
    assert got.shape == want.shape == symmetric.shape == (2, 4, 4, 6)
    assert close(got, want, *BF16) <= 0
    assert close(symmetric, want, *BF16) > 0.5  # windows one pixel apart
    assert tr._same_padding(8, 3, 2) == (0, 1) and tr._same_padding(8, 3, 1) == (1, 1)
    assert tr._same_padding(8, 1, 2) == (0, 0) and tr._same_padding(7, 3, 2) == (1, 1)


def test_sgd_matches_optax_nesterov_with_decay():
    rng = np.random.default_rng(3)
    shapes = [(8, 4, 3, 3), (8,), (10, 8)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    lr, momentum, wd = 0.1, 0.9, 1e-2
    tx = optax.chain(optax.add_decayed_weights(wd),
                     optax.sgd(lr, momentum=momentum, nesterov=True))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = tr.SGD(tp, lr, momentum, wd)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
        opt.zero_grad()
        for got, want in zip(tp, jp):
            # measured: 2.4e-7 after three steps
            assert close(got.detach(), want, 1e-6, 1e-6) <= 0
    assert all(p.grad is None for p in tp)


def test_init_distributions_match_flax():
    port = tr.ResNet(depth=50, width=16).init_like_flax(torch.Generator().manual_seed(0))
    ref = jax.jit(partial(jr.ResNet(depth=50, width=16).init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    want = tr.params_from_flax(ref["params"], ref["batch_stats"])
    got = port.state_dict()
    for k, w in want.items():
        g = got[k]
        if k.endswith(("bias", "running_mean")):
            assert torch.all(g == 0) and torch.all(w == 0), k
        elif k.endswith("running_var"):
            assert torch.all(g == 1) and torch.all(w == 1), k
        elif g.dim() == 1:  # batch-norm scales: 1, or 0 for a block's last
            assert torch.equal(g, w), k
        else:  # lecun-normal kernels truncated at 2 sigma
            fan_in = g[0].numel()
            bound = 2 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert g.abs().max() <= bound and w.abs().max() <= bound * (1 + 1e-6), k
            if g.numel() >= 4096:
                assert abs(float(g.std()) * math.sqrt(fan_in) - 1) < 0.1, k
                assert abs(float(w.std()) * math.sqrt(fan_in) - 1) < 0.1, k
    zero = [k for k, v in got.items() if k.endswith(".weight") and v.dim() == 1
            and torch.all(v == 0)]
    assert zero == [f"blocks.{i}.bn3.weight" for i in range(16)]


def test_train_and_eval_on_cpu_lowers_the_loss():
    partials, rep = [], {}
    err = tr.train_and_eval({"lr": 0.05, "depth": 18, "batch_size": 32, "width": 16},
                            n_train=128, n_val=64, epochs=3, hw=16, device="cpu",
                            on_epoch=lambda e, v: partials.append((e, v)), report=rep)
    assert 0.0 <= err <= 1.0
    assert [e for e, _ in partials] == [1, 2, 3] and partials[-1][1] == err
    assert rep["steps"] == 12 and len(rep["losses"]) == 3
    assert rep["losses"][-1] < rep["losses"][0]
    assert 0 < rep["train_s"] and 0 < rep["eval_s"] and rep["setup_s"] < rep["trial_s"]


def test_one_step_per_epoch_when_the_batch_exceeds_the_data():
    rep = {}
    tr.train_and_eval({"lr": 0.05, "depth": 18, "batch_size": 64, "width": 8}, n_train=16,
                      n_val=8, epochs=2, hw=8, device="cpu", report=rep)
    assert rep["steps"] == 2


def test_make_objective_maps_epochs_like_reference(monkeypatch):
    seen = []
    monkeypatch.setattr(tr, "train_and_eval", lambda hp, **kw: seen.append(kw) or 0.25)
    assert tr.make_objective(depth=18)({"lr": 0.1, "epochs": 4}) == 0.25
    assert seen == [{"depth": 18, "epochs": 4}]


def test_a_trial_process_never_imports_dynamo():
    code = ("import sys; from metaopt_tpu_torch.models import resnet; "
            "resnet.train_and_eval({'lr': 0.1, 'depth': 18, 'width': 8, 'batch_size': 8}, "
            "n_train=16, n_val=8, hw=8, device='cpu'); "
            "print(sorted(m for m in sys.modules if m.startswith('torch._dynamo')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_resnet_entry_point_never_drifts_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.train_and_eval({"lr": 0.1, "depth": 18, "width": 8}, n_train=8, n_val=8, hw=8)
