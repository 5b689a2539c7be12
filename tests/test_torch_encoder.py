"""The port's sparse encoder (``repro_torch.models``) held against the JAX
package's, on the CPU, with the reference's parameters carried across by
``convert.encoder_params_from_arrays``.

Every comparison is fp32 on both sides and holds to rtol = atol = 1e-5
(the two frameworks sum products in different orders); ids and masks are
exact. The cases:

  * ``apply_norm`` (rms, ln, nonparam_ln), ``apply_mlp`` (gelu, swiglu),
    ``apply_mlp_stack``, ``cross_entropy_loss``, ``apply_rope``;
  * ``chunked_causal_attention``, causal and not, with a chunk shorter
    than the sequence and KV padding; ``attend_train``, ``attend_decode``;
  * ``encode``'s three outputs at tests/test_arch_smoke.py's smoke config
    (V 512, d 64, 2 layers), rows partly and wholly masked;
    ``contrastive_loss``'s value; ``to_sparse_docs`` on rows with exact
    ties and zeros;
  * the init: every parameter's name, shape and scale, and the published
    width's parameter count.

The ``gpu`` test runs ``encode`` on the card against the CPU. This file
collects without JAX (the machine with the card has none): the reference
is imported inside the tests that use it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.convert import encoder_params_from_arrays
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import sparse_encoder as t_se

TOL = dict(rtol=1e-5, atol=1e-5)
SMOKE = dict(vocab=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq=32)


def _close(got: torch.Tensor, want, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def _rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("norm", ["rms", "ln", "nonparam_ln"])
def test_apply_norm(norm):
    import jax.numpy as jnp

    from repro.models import layers as j_layers
    rng = _rng(1)
    x = rng.normal(2.0, 3.0, (3, 5, 16)).astype(np.float32)
    p = {"scale": rng.normal(1.0, 0.2, 16).astype(np.float32),
         "bias": rng.normal(0.0, 0.2, 16).astype(np.float32)}
    if norm == "rms":
        p.pop("bias")
    if norm == "nonparam_ln":
        p = {}
    want = j_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), norm)
    _close(t_layers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x),
                               norm), want)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_apply_mlp(act):
    import jax.numpy as jnp

    from repro.models import layers as j_layers
    rng = _rng(2)
    x = rng.normal(0.0, 1.0, (2, 7, 16)).astype(np.float32)
    p = {"w_up": rng.normal(0, 0.3, (16, 40)).astype(np.float32),
         "w_down": rng.normal(0, 0.3, (40, 16)).astype(np.float32)}
    if act == "swiglu":
        p["w_gate"] = rng.normal(0, 0.3, (16, 40)).astype(np.float32)
    want = j_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), act)
    _close(t_layers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act),
           want)


@pytest.mark.parametrize("final_act", [False, True])
def test_apply_mlp_stack(final_act):
    import jax.numpy as jnp

    from repro.models import layers as j_layers
    rng = _rng(12)
    dims = [12, 20, 7]
    p = {f"layer{i}": {"w": rng.normal(0, 0.4, (dims[i], dims[i + 1])
                                       ).astype(np.float32),
                       "b": rng.normal(0, 0.1, dims[i + 1]
                                       ).astype(np.float32)}
         for i in range(len(dims) - 1)}
    x = rng.normal(0, 1, (5, 12)).astype(np.float32)
    want = j_layers.apply_mlp_stack(_tree(p, jnp.asarray), jnp.asarray(x),
                                    final_act=final_act)
    _close(t_layers.apply_mlp_stack(_tree(p, _t), _t(x),
                                    final_act=final_act), want)
    shapes = {k: {n: tuple(v.shape) for n, v in layer.items()}
              for k, layer in t_layers.mlp_stack_init(
                  torch.Generator().manual_seed(0), dims).items()}
    assert shapes == {k: {n: v.shape for n, v in layer.items()}
                      for k, layer in p.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss(masked):
    import jax.numpy as jnp

    from repro.models import layers as j_layers
    rng = _rng(13)
    logits = rng.normal(0, 2, (3, 6, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 6)).astype(np.int32)
    mask = (rng.random((3, 6)) < 0.6).astype(np.float32) if masked else None
    want = j_layers.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = t_layers.cross_entropy_loss(_t(logits), _t(labels).long(),
                                      None if mask is None else _t(mask))
    _close(got, want)


def test_apply_rope():
    import jax.numpy as jnp

    from repro.models import layers as j_layers
    rng = _rng(3)
    x = rng.normal(0.0, 1.0, (2, 3, 9, 8)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 3, 9)).astype(np.int32)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _close(t_layers.apply_rope(_t(x), _t(pos), 1e4), want)


def _qkv(rng, B=2, S=10, G=2, P=2, H=4):
    q = rng.normal(0, 1, (B, S, G, P, H)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, G, H)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, G, H)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,chunk", [(True, 4), (False, 4),
                                          (True, 16), (False, 3)])
def test_chunked_attention(causal, chunk):
    """chunk 4 and 3 do not divide S = 10 (KV padded); 16 exceeds it."""
    import jax.numpy as jnp

    from repro.models import attention as j_attn
    q, k, v = _qkv(_rng(4))
    want = j_attn.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk,
        causal=causal)
    got = t_attn.chunked_causal_attention(_t(q), _t(k), _t(v), chunk=chunk,
                                          causal=causal)
    _close(got, want)


def _attn_params(rng, d=16, G=2, P=2, H=4) -> dict:
    return {"wq": rng.normal(0, 0.25, (d, G, P, H)).astype(np.float32),
            "wk": rng.normal(0, 0.25, (d, G, H)).astype(np.float32),
            "wv": rng.normal(0, 0.25, (d, G, H)).astype(np.float32),
            "wo": rng.normal(0, 0.25, (G, P, H, d)).astype(np.float32),
            "q_norm": {"scale": rng.normal(1, 0.1, H).astype(np.float32)},
            "k_norm": {"scale": rng.normal(1, 0.1, H).astype(np.float32)}}


def _tree(p: dict, to):
    return {k: _tree(v, to) if isinstance(v, dict) else to(v)
            for k, v in p.items()}


@pytest.mark.parametrize("qk_norm,causal", [(False, False), (True, True)])
def test_attend_train(qk_norm, causal):
    import jax.numpy as jnp

    from repro.models import attention as j_attn
    rng = _rng(5)
    p = _attn_params(rng)
    x = rng.normal(0, 1, (2, 11, 16)).astype(np.float32)
    want = j_attn.attend_train(_tree(p, jnp.asarray), jnp.asarray(x),
                               qk_norm=qk_norm, rope_theta=1e4, chunk=4,
                               causal=causal)
    got = t_attn.attend_train(_tree(p, _t), _t(x), qk_norm=qk_norm,
                              rope_theta=1e4, chunk=4, causal=causal)
    _close(got, want)


def test_attend_decode():
    import jax.numpy as jnp

    from repro.models import attention as j_attn
    rng = _rng(6)
    p = _attn_params(rng)
    x = rng.normal(0, 1, (2, 1, 16)).astype(np.float32)
    ck = rng.normal(0, 1, (2, 12, 2, 4)).astype(np.float32)
    cv = rng.normal(0, 1, (2, 12, 2, 4)).astype(np.float32)
    want = j_attn.attend_decode(_tree(p, jnp.asarray), jnp.asarray(x),
                                jnp.asarray(ck), jnp.asarray(cv),
                                jnp.int32(5), qk_norm=True, rope_theta=1e4)
    got = t_attn.attend_decode(_tree(p, _t), _t(x), _t(ck), _t(cv),
                               torch.tensor(5), qk_norm=True,
                               rope_theta=1e4)
    for g, w, what in zip(got, want, ("out", "cache_k", "cache_v")):
        _close(g, w, what)


_ENC: dict = {}


def _encoders():
    """The reference's smoke-config encoder and the port's, carried
    across."""
    if not _ENC:
        import jax

        from repro.models import sparse_encoder as j_se
        cfg = j_se.SparseEncConfig(**SMOKE)
        params = j_se.init_params(jax.random.PRNGKey(0), cfg)
        tree = jax.tree_util.tree_map(np.asarray, params)
        model = encoder_params_from_arrays(tree, t_se.SparseEncConfig(
            **SMOKE), device="cpu")
        _ENC.update(j_se=j_se, cfg=cfg, params=params, model=model)
    return _ENC


def _tokens(seed: int, B: int = 4, S: int = 32):
    """Tokens and a mask with a short row and a wholly dead one."""
    rng = _rng(seed)
    toks = rng.integers(0, SMOKE["vocab"], (B, S)).astype(np.int32)
    lens = np.array([S, 20, 1, 0][:B] + [S] * max(B - 4, 0))
    mask = np.arange(S)[None, :] < lens[:, None]
    return toks, mask


def test_encode_matches_reference():
    import jax.numpy as jnp
    e = _encoders()
    toks, mask = _tokens(7)
    want = e["j_se"].encode(e["params"], jnp.asarray(toks),
                            jnp.asarray(mask), e["cfg"])
    with torch.no_grad():
        got = t_se.encode(e["model"], _t(toks).long(), _t(mask))
    for key in ("sparse", "dense_max", "token_emb"):
        _close(got[key], want[key], key)
    assert bool((got["dense_max"][3] == t_se.DEAD).all())
    assert bool((got["sparse"][3] == 0).all())
    assert bool((got["sparse"] >= 0).all())


def test_contrastive_loss_matches_reference():
    import jax.numpy as jnp
    e = _encoders()
    qt, qm = _tokens(8)
    dt, dm = _tokens(9)
    qm[3] = True
    dm[3, :5] = True
    want = e["j_se"].contrastive_loss(e["params"], {
        "q_tokens": jnp.asarray(qt), "q_mask": jnp.asarray(qm),
        "d_tokens": jnp.asarray(dt), "d_mask": jnp.asarray(dm)}, e["cfg"])
    with torch.no_grad():
        got = t_se.contrastive_loss(e["model"], {
            "q_tokens": _t(qt).long(), "q_mask": _t(qm),
            "d_tokens": _t(dt).long(), "d_mask": _t(dm)})
    _close(got, want)


def test_to_sparse_docs_ties_and_zeros():
    """Equal weights keep the lower id first, as ``jax.lax.top_k``; rows
    with fewer nonzeros than t_pad carry masked zero slots."""
    import jax.numpy as jnp
    e = _encoders()
    rng = _rng(10)
    mat = rng.choice(np.float32([0.0, 0.0, 0.0, 0.5, 1.0, 2.0]),
                     (5, 40)).astype(np.float32)
    mat[1] = 0.0
    mat[2, :] = 0.0
    mat[2, [3, 17, 30]] = 1.5
    want = e["j_se"].to_sparse_docs(jnp.asarray(mat), t_pad=12, vocab=40)
    got = t_se.to_sparse_docs(_t(mat), t_pad=12, vocab=40)
    for f in ("tids", "tw", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.tids.dtype == torch.int32 and got.vocab == 40


def _named_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_init_shapes_and_scales():
    """Every parameter of the reference's tree, by name and shape (the
    stacked layer axis unstacked); the scales: embed a normal truncated
    at 2 sigma, sigma = 1/sqrt(V); dense weights 1/sqrt(d_in); norms ones
    and zeros; the MLM bias zeros."""
    import jax

    from repro.models import sparse_encoder as j_se
    cfg = t_se.SparseEncConfig(**SMOKE)
    model = t_se.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ref = j_se.init_params(jax.random.PRNGKey(0), j_se.SparseEncConfig(
        **SMOKE))
    want = _named_shapes({k: v for k, v in ref.items() if k != "layers"})
    for k, shape in _named_shapes(ref["layers"], "layers.").items():
        for i in range(cfg.n_layers):
            want[k.replace("layers.", f"layers.{i}.", 1)] = shape[1:]
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    sigma = 1.0 / np.sqrt(cfg.vocab)
    emb = model.embed.detach().numpy()
    assert np.abs(emb).max() <= 2 * sigma + 1e-7
    # a normal truncated at +-2 sigma has std 0.880 sigma
    assert abs(emb.std() / (0.8796 * sigma) - 1) < 0.05
    for i, layer in enumerate(model.layers):
        for name, d_in in (("wq", cfg.d_model), ("wk", cfg.d_model),
                           ("wv", cfg.d_model),
                           ("wo", cfg.n_heads * cfg.head_dim)):
            std = layer.attn[name].detach().std().item()
            assert abs(std * np.sqrt(d_in) - 1) < 0.1, (i, name)
        assert abs(layer.mlp["w_up"].detach().std().item()
                   * np.sqrt(cfg.d_model) - 1) < 0.1
        assert abs(layer.mlp["w_down"].detach().std().item()
                   * np.sqrt(cfg.d_ff) - 1) < 0.1
        assert bool((layer.ln1["scale"] == 1).all())
        assert bool((layer.ln2["bias"] == 0).all())
    assert bool((model.mlm_bias == 0).all())
    same = t_se.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 same.parameters()))


def test_published_width_parameter_count():
    """SparseEncConfig()'s widths hold 10,994,490 parameters, the count of
    the reference's shapes (the reference example's "~100M" is not)."""
    import jax

    from repro.models import sparse_encoder as j_se
    shapes = jax.eval_shape(lambda: j_se.init_params(
        jax.random.PRNGKey(0), j_se.SparseEncConfig()))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes))
    cfg = t_se.SparseEncConfig()
    model = t_se.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert model.n_params() == want == 10_994_490


def test_converter_refuses_a_wrong_layer_count():
    e = _encoders()
    import jax
    tree = jax.tree_util.tree_map(np.asarray, e["params"])
    with pytest.raises(ValueError, match="stacks 2 layers"):
        encoder_params_from_arrays(tree, t_se.SparseEncConfig(
            **{**SMOKE, "n_layers": 3}), device="cpu")


@pytest.mark.gpu
def test_encode_on_card_equals_cpu(monkeypatch):
    """The same random weights on the card (fp32, TF32 off) and on the
    CPU: sparse, dense_max and token_emb to rtol 1e-4 / atol 1e-5, each
    device also against the same weights in float64 on the CPU (so a
    failure names the device that drifted), and to_sparse_docs' weights
    position by position."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = t_se.SparseEncConfig(**SMOKE)

    def model(device):
        return t_se.init_params(torch.Generator().manual_seed(3), cfg,
                                device=device)
    toks, mask = _tokens(11, B=6)
    with torch.no_grad():
        exact = t_se.encode(model("cpu").double(), _t(toks).long(),
                            _t(mask))
        want = t_se.encode(model("cpu"), _t(toks).long(), _t(mask))
        got = t_se.encode(model("cuda"), _t(toks).long(), _t(mask))
    for key in ("sparse", "dense_max", "token_emb"):
        ref = exact[key].float()
        for what, out in (("cpu", want[key]), ("card", got[key].cpu()),
                          ("card vs cpu", got[key].cpu())):
            torch.testing.assert_close(
                out, want[key] if what == "card vs cpu" else ref,
                rtol=1e-4, atol=1e-5, msg=lambda m: f"{key}, {what}: {m}")
    w = t_se.to_sparse_docs(want["sparse"], 16, cfg.vocab)
    g = t_se.to_sparse_docs(got["sparse"].cpu(), 16, cfg.vocab)
    torch.testing.assert_close(g.tw, w.tw, rtol=1e-4, atol=1e-5)
