"""The port's decoder-only LM against the JAX package's, on the CPU.

A small LM (2 layers, d_model 64, one head of 64, d_ff 64, vocab 64) is
initialized by flax, carried over by ``params_from_flax`` and fed the same
numpy tokens in both packages; the JAX model routes attention through the
Pallas kernels in interpret mode (``METAOPT_TPU_FLASH=pallas``), or at
dropout through its chunked twin, and the port through the plain versions
of K1–K3. Held: logits, ``lm_loss_fn`` and every gradient at the bf16
bounds of ``tests/test_torch_transformer.py``; at dropout 0.1 the same,
with the reference's own feed-forward masks and attention bits (its
``_dropout_tile`` threefry bits, as ``tests/test_torch_dropout.py`` feeds
them) injected through ``GivenDraws``; a MoE LM; the residual's dtype per
layer. The reference's own cases (``tests/unit/test_lm.py``) are restated:
causality, the ``max_len`` error, blocked xent equal to the materialized
one within 0.05, training lowers the loss, the MoE LM runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import metaopt_tpu.ops.attention as jatt
from metaopt_tpu.models import lm as jlm
from metaopt_tpu.models import transformer as jt
from metaopt_tpu_torch.models import lm, transformer as tt
from metaopt_tpu_torch.ops import attention as att
from metaopt_tpu_torch.ops import xent
from test_torch_dropout import reference_bits

HP = dict(vocab=64, d_model=64, n_heads=1, n_layers=2, d_ff=64, dropout=0.0, max_len=32)


def tokens(seed=0, b=3, t=17, vocab=64):
    """(b, t) tokens in [2, vocab) with a padded tail on one row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, vocab, (b, t))
    toks[1, 12:] = 0
    return toks


def flax_lm(hp, seed=0):
    model = jlm.make_lm(hp)
    z = jnp.zeros((1, 4), jnp.int32)
    params = nn.meta.unbox(jax.jit(lambda key: model.init(key, z, train=False))(
        jax.random.PRNGKey(seed))["params"])
    return model, params


def port_lm(hp, params):
    model = lm.make_lm(hp)
    model.load_state_dict(tt.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return model


def assert_grads_match(model, jgrads, bound=3e-2):
    """Every gradient within the bf16 bound relative to its tensor's scale
    (the backward rounds to bf16 at each dense layer in both packages, in
    different orders), as ``tests/test_torch_transformer.py`` holds them."""
    ref = tt.params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        mine, want = p.grad.numpy(), ref[name].numpy()
        assert np.isfinite(mine).all(), name
        if name.endswith("k.bias"):   # zero in exact arithmetic: bf16 noise only
            assert np.abs(mine).max() < 1e-3 and np.abs(want).max() < 1e-3, name
            continue
        scale = np.abs(want).max()
        np.testing.assert_allclose(mine, want, atol=bound * scale, rtol=bound, err_msg=name)


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("METAOPT_TPU_FLASH", "pallas")


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_logits_loss_and_gradients_match_flax(n_experts):
    hp = dict(HP, n_experts=n_experts)
    jmodel, params = flax_lm(hp)
    model = port_lm(hp, params)
    toks = tokens(n_experts)
    jlogits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks[:, :-1]),
                                      train=False))
    logits = model(torch.from_numpy(toks[:, :-1]))
    assert logits.dtype == torch.float32 and logits.shape == (3, 16, 64)
    # the bf16 bound relative to the logits' scale (a normal(1) table at d 64
    # gives logits up to 54-66 here): measured 0 for the dense LM, where both
    # packages round the same bf16 values at the same places, and 0.055 with
    # MoE layers, whose f32 residual carries each framework's f32 router
    # rounding into the next bf16 casts (tests/test_torch_moe.py)
    scale = np.abs(jlogits).max()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=3e-2 * scale, rtol=3e-2)

    jloss, jgrads = jax.value_and_grad(lambda p: jlm.lm_loss_fn(
        jmodel, p, jnp.asarray(toks), jax.random.PRNGKey(1)))(params)
    stats = {}
    loss = lm.lm_loss_fn(model, torch.from_numpy(toks), stats=stats)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=3e-2)
    assert stats["blocked_xent"] is False
    assert len(stats.get("aux_loss", [])) == (2 if n_experts else 0)
    loss.backward()
    assert_grads_match(model, jgrads)


def record_reference_draws(monkeypatch):
    """Record what the reference's LM draws in one train-mode call: its
    feed-forward masks (flax ``nn.Dropout``'s ``bernoulli`` outside any
    trace) and each attention call's dropout key and shape."""
    ffn, attn = [], []
    bernoulli = jax.random.bernoulli

    def recording_bernoulli(key, p=0.5, shape=None):
        m = bernoulli(key, p, shape)
        if not isinstance(m, jax.core.Tracer):   # the chunked twin's tiles are traced
            ffn.append(np.asarray(m))
        return m

    flash = jatt.flash_attention

    def recording_flash(q, k, v, mask=None, **kw):
        if kw.get("dropout_rate", 0.0) > 0.0:
            attn.append((np.asarray(kw["dropout_key"]), q.shape, k.shape[1]))
        return flash(q, k, v, mask, **kw)

    monkeypatch.setattr(jax.random, "bernoulli", recording_bernoulli)
    monkeypatch.setattr(jatt, "flash_attention", recording_flash)
    return ffn, attn


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_dropout_matches_flax_on_its_masks_and_attention_bits(monkeypatch, n_experts):
    """Train mode at dropout 0.1: the reference's feed-forward masks and its
    attention keep bits (``_dropout_tile`` over 128-wide blocks, the
    reference's default) injected through ``GivenDraws``: loss and every
    gradient within the bf16 bounds."""
    rate = 0.1
    hp = dict(HP, n_experts=n_experts, dropout=rate)
    jmodel, params = flax_lm(hp, seed=2)
    model = port_lm(hp, params)
    toks = tokens(3)
    ffn, attn = record_reference_draws(monkeypatch)
    jloss, jgrads = jax.value_and_grad(lambda p: jlm.lm_loss_fn(
        jmodel, p, jnp.asarray(toks), jax.random.PRNGKey(5)))(params)
    monkeypatch.undo()
    assert len(attn) == 2 and len(ffn) == 2
    keep = [reference_bits(jnp.asarray(key), rate, q[0], q[2], q[1], sk, 128, 128)
            for key, q, sk in attn]
    assert all(0.8 < k.mean() < 0.97 for k in keep) and all(0.8 < m.mean() < 0.97 for m in ffn)

    draws = tt.GivenDraws(ffn, attention_seed=0, device="cpu", attention_keep=keep)
    loss = lm.lm_loss_fn(model, torch.from_numpy(toks), draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=3e-2)
    loss.backward()
    assert_grads_match(model, jgrads)

    # the masks matter: without them (evaluation) the loss moves
    clean = float(lm.lm_loss_fn(model, torch.from_numpy(toks)))
    assert abs(clean - float(jloss)) > 1e-3 * abs(clean)


@pytest.mark.parametrize("n_experts,want", [(0, (jnp.bfloat16, torch.bfloat16)),
                                             (4, (jnp.float32, torch.float32))])
def test_the_residual_dtype_per_layer_matches_flax(n_experts, want):
    """Each block's output dtype: bf16 with dense FFNs, f32 from the first
    MoE layer on (the MoE returns its f32 input's dtype), in both packages."""
    hp = dict(HP, n_experts=n_experts, n_layers=3)
    jmodel, params = flax_lm(hp)
    model = port_lm(hp, params)
    toks = tokens(4)
    _, inter = jmodel.apply({"params": params}, jnp.asarray(toks), train=False,
                            capture_intermediates=True)
    outs = []
    for layer in model.h:
        layer.register_forward_hook(lambda mod, i, o: outs.append(o.dtype))
    model(torch.from_numpy(toks))
    for i in range(3):
        assert inter["intermediates"][f"h{i}"]["__call__"][0].dtype == want[0], i
    assert outs == [want[1]] * 3


def test_params_from_flax_covers_every_parameter():
    for n_experts in (0, 4):
        hp = dict(HP, n_experts=n_experts)
        _, params = flax_lm(hp)
        sd = tt.params_from_flax(jax.tree.map(np.asarray, params))
        assert set(sd) == {k for k, _ in lm.make_lm(hp).named_parameters()}
        assert sum(v.numel() for v in sd.values()) == sum(
            np.asarray(x).size for x in jax.tree.leaves(params))


def test_make_lm_takes_the_reference_defaults():
    ref = jlm.make_lm({})
    model = lm.make_lm({})
    assert (model.vocab, model.max_len, model.remat) == (ref.vocab, ref.max_len, ref.remat)
    assert len(model.h) == ref.n_layers == 6
    assert model.embed.weight.shape == (ref.vocab, ref.d_model)
    layer = model.h[0]
    assert layer.self_attn.n_heads == ref.n_heads and layer.mlp.wi.out_features == ref.d_ff
    assert layer.dropout == ref.dropout == 0.1
    moe = lm.make_lm({"n_experts": 8, "router_top_k": 2}, d_model=64, n_layers=1)
    assert moe.h[0].mlp.n_experts == 8 and moe.h[0].mlp.k == 2
    assert moe.h[0].mlp.capacity_factor == jlm.make_lm({}).capacity_factor == 1.25


def test_a_fresh_lm_holds_no_uninitialized_memory_and_inits_like_flax():
    junk = torch.full((32, 64), float("nan"))
    del junk
    model = lm.make_lm(HP)
    for k, v in model.named_parameters():
        assert torch.isfinite(v).all(), k
    assert not model.pos_embed.any()
    model = lm.make_lm(dict(HP, vocab=512, d_model=256, n_heads=4, max_len=512))
    model.init_like_flax(torch.Generator().manual_seed(0))
    assert abs(float(model.embed.weight.std()) - 1.0) < 0.02
    assert abs(float(model.pos_embed.std()) - 0.02) < 0.002


# ---------------------------------------------------------------------------
# the reference's own cases, restated on the port


def tiny(**over):
    h = {"d_model": 32, "n_heads": 1, "n_layers": 2, "d_ff": 64, "vocab": 64, "dropout": 0.0}
    h.update(over)
    return lm.make_lm(h).init_like_flax(torch.Generator().manual_seed(0))


def test_forward_shape_and_causality():
    """Perturbing token t changes no logit at positions < t, and changes t's."""
    model = tiny()
    toks = torch.arange(2 * 16).reshape(2, 16) % 62 + 2
    base = model(toks)
    assert base.shape == (2, 16, 64)
    poked = toks.clone()
    poked[:, 10] = (toks[:, 10] - 2 + 1) % 62 + 2
    out = model(poked)
    np.testing.assert_allclose(base[:, :10].detach().numpy(), out[:, :10].detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(base[:, 10].detach().numpy(), out[:, 10].detach().numpy())


def test_max_len_overflow_is_loud_with_the_reference_message():
    model = tiny(max_len=8)
    with pytest.raises(ValueError, match="max_len") as mine:
        model(torch.ones((1, 9), dtype=torch.int64))
    jmodel = jlm.make_lm({"d_model": 32, "n_heads": 1, "n_layers": 1, "d_ff": 64,
                          "vocab": 64, "max_len": 8})
    with pytest.raises(ValueError) as ref:
        jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 9), jnp.int32), train=False)
    assert str(mine.value) == str(ref.value)


def test_loss_blocked_matches_dense(monkeypatch):
    """Both xent routes give the same next-token loss (the materialized
    route rounds nothing more than the blocked one: both multiply bf16
    features by the table, one in f32 against the f32 table, one against a
    bf16 copy), and the reference's blocked loss within 0.05."""
    hp = dict(HP, n_experts=0)
    jmodel, params = flax_lm(hp, seed=4)
    model = port_lm(hp, params)
    toks = tokens(5)
    monkeypatch.setattr(tt, "_BLOCKED_XENT_MIN_LOGITS_BYTES", 1 << 62)
    stats = {}
    dense = float(lm.lm_loss_fn(model, torch.from_numpy(toks), stats=stats))
    assert stats["blocked_xent"] is False
    monkeypatch.setattr(tt, "_BLOCKED_XENT_MIN_LOGITS_BYTES", 1)
    seen = []

    def spy(*args):
        seen.append(args[0].shape)
        return xent.blocked_softmax_xent(*args)

    monkeypatch.setattr(tt, "blocked_softmax_xent", spy)
    blocked = lm.lm_loss_fn(model, torch.from_numpy(toks), stats=stats)
    assert stats["blocked_xent"] is True and len(seen) == 1
    assert abs(dense - float(blocked)) < 0.05
    monkeypatch.setattr(jt, "_BLOCKED_XENT_MIN_LOGITS_BYTES", 1)
    ref = float(jlm.lm_loss_fn(jmodel, params, jnp.asarray(toks), jax.random.PRNGKey(3)))
    assert abs(ref - float(blocked)) < 0.05
    blocked.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_train_lm_guards_empty_batching():
    with pytest.raises(ValueError, match="n_train"):
        lm.train_lm({"d_model": 32, "n_heads": 1, "n_layers": 1, "d_ff": 64, "vocab": 32},
                    n_train=8, batch_size=32, device="cpu")


def test_training_reduces_loss_and_is_reproducible():
    """The permutation-walk task is exactly learnable: the loss drops well
    below the uniform floor (ln 30 ≈ 3.4) within 60 steps."""
    hp = {"d_model": 32, "n_heads": 1, "n_layers": 1, "d_ff": 64, "vocab": 32,
          "dropout": 0.0, "lr": 5e-2}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reps = [{}, {}]
        losses = [lm.train_lm(hp, n_train=256, batch_size=32, seq_len=16, steps=60,
                              device="cpu", report=r) for r in reps]
    finally:
        torch.set_num_threads(n_threads)
    assert losses[0] < 1.5, losses
    assert losses[0] == losses[1] and reps[0]["losses"] == reps[1]["losses"]
    assert reps[0]["tokens_per_step"] == 32 * 16 and reps[0]["updates"] == 60


def test_moe_lm_runs():
    model = tiny(n_experts=4)
    toks = torch.from_numpy(np.random.default_rng(1).integers(2, 64, (4, 8)))
    stats = {}
    loss = lm.lm_loss_fn(model, toks, tt.Draws(0, 0, "cpu"), stats=stats)
    assert torch.isfinite(loss)
    assert len(stats["aux_loss"]) == 2 and all(0.0 <= float(d) < 1.0
                                               for d in stats["moe_stats"])


def test_train_lm_takes_the_reference_batch_walk(monkeypatch):
    """Step i trains on rows ``(i · batch) % (n_train − batch + 1)`` onward."""
    seen = []
    monkeypatch.setattr(lm, "make_lm_train_step",
                        lambda model, opt: lambda toks, draws: seen.append(toks[:, 0].clone())
                        or torch.zeros(()))
    data = lm.synthetic_lm(10, 5, 32, seed=0, device="cpu")
    lm.train_lm({"d_model": 32, "n_heads": 1, "n_layers": 1, "d_ff": 64, "vocab": 32},
                n_train=10, batch_size=4, seq_len=4, steps=5, device="cpu")
    for i, first in enumerate(seen):
        lo = (i * 4) % 7
        assert torch.equal(first, data[lo:lo + 4, 0]), i


def test_train_lm_saves_and_restores_its_checkpoint(tmp_path):
    hp = {"d_model": 32, "n_heads": 1, "n_layers": 1, "d_ff": 64, "vocab": 32,
          "dropout": 0.1, "lr": 1e-2, "warmup": 1}
    kw = dict(n_train=64, batch_size=8, seq_len=8, device="cpu")
    first = {}
    lm.train_lm(hp, steps=3, save_dir=str(tmp_path), report=first, **kw)
    assert first["restored"] is False and first["updates"] == 3
    assert (tmp_path / tt.CKPT_FILE).is_file()
    second = {}
    lm.train_lm(hp, steps=2, restore_dir=str(tmp_path), report=second, **kw)
    assert second["restored"] is True and second["restored_updates"] == 3
    assert second["updates"] == 5


def test_meshes_raise_as_for_the_transformer():
    for kw in ({"tp": 2}, {"sp": 2}, {"ep": 2}):
        with pytest.raises(NotImplementedError, match="tp/sp/ep"):
            lm.train_lm({"d_model": 32, "n_heads": 1, "n_layers": 1, "d_ff": 64,
                         "vocab": 32}, n_train=8, batch_size=4, seq_len=4, steps=1,
                        device="cpu", **kw)


def test_train_lm_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.train_lm({"d_model": 32, "n_heads": 1, "n_layers": 1, "d_ff": 64, "vocab": 32},
                    n_train=8, batch_size=4, seq_len=4, steps=1)


# ---------------------------------------------------------------------------
# the data


def test_synthetic_lm_is_one_permutation_walk():
    """x[t+1] = perm[x[t]] over [2, vocab), the permutation shared by every
    seed (keyed by teacher_seed alone), the starts drawn by seed."""
    vocab = 50
    a = lm.synthetic_lm(64, 12, vocab, seed=0, device="cpu")
    b = lm.synthetic_lm(64, 12, vocab, seed=1, device="cpu")
    assert a.shape == (64, 12) and a.dtype == torch.int64
    assert int(a.min()) >= 2 and int(a.max()) < vocab
    step = {}
    for x in (a, b):
        for cur, nxt in zip(x[:, :-1].reshape(-1).tolist(), x[:, 1:].reshape(-1).tolist()):
            assert step.setdefault(cur, nxt) == nxt
    assert len(set(step.values())) == len(step)            # a bijection on what it saw
    assert not torch.equal(a[:, 0], b[:, 0])
    assert torch.equal(a, lm.synthetic_lm(64, 12, vocab, seed=0, device="cpu"))
    other = lm.synthetic_lm(64, 12, vocab, seed=0, teacher_seed=8, device="cpu")
    assert torch.equal(other[:, 0], a[:, 0]) and not torch.equal(other, a)


def test_attention_runs_with_the_causal_mask_on_the_kernels_path(monkeypatch):
    """Every block's attention is one ``flash_attention`` call with the
    (B, S, S) mask ``tril & pad`` read through broadcast strides."""
    seen = []
    real = att.flash_attention

    def spy(q, k, v, mask=None, **kw):
        seen.append(mask.clone())
        return real(q, k, v, mask, **kw)

    monkeypatch.setattr(tt, "flash_attention", spy)
    toks = torch.from_numpy(tokens(6))[:, :-1]
    tiny()(toks)
    want = torch.tril(torch.ones(16, 16, dtype=torch.bool))[None] & (toks != 0)[:, None, :]
    assert len(seen) == 2 and all(torch.equal(m != 0, want) for m in seen)


def test_injected_keep_bits_run_only_in_the_plain_versions():
    """``keep`` reaches the plain versions on CPU tensors only: a tensor on
    any other device is refused before a launch, and a dropout call takes
    exactly one source of bits."""
    q = torch.empty(1, 8, 1, 32, device="meta")
    keep = torch.ones(1, 1, 8, 8, dtype=torch.bool)
    for fn, args in ((att.flash_fwd, (q, q, q)),
                     (att.flash_bwd_dq, (q, q, q, q, torch.empty(1, 1, 8, device="meta"),
                                         torch.empty(1, 1, 8, device="meta")))):
        with pytest.raises(ValueError, match="plain version"):
            fn(*args, dropout_rate=0.1, seed=1, keep=keep)
    x = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="one of"):
        att.flash_attention(x, x, x, dropout_rate=0.1, philox=(1, 2), keep=keep)
