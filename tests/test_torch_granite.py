"""granite_moe_1b and qwen3_moe_235b through the port against the JAX
package, on the CPU: the MoE layer (``("attn", "moe")``) in the model
stack, and qwen3's QK-norm.  Reduced granite runs under its published
int8 format at its published capacity factor 1.25 (the reduced config's
4.0 never drops an assignment), reduced qwen3_moe in f32 with QK-norm;
JAX on its pallas backend in interpret mode, the port on its plain
versions, parameters carried across by
``repro_torch.convert.params_from_jax``.

Compared: the configs field for field and their parameter counts;
``forward`` logits and ``loss_fn`` (the MoE aux loss included),
``prefill_chunk`` and ``decode`` logits within the model tolerance of
the format (int8: 2e-2; f32: 1e-4), with assignments dropped; the
serving engine against the JAX engine (equal greedy
streams, page tables after every step, prefix registrations and
counters); the engine's refusal of speculation on a MoE config; the
dtypes ``serving_params`` gives every MoE leaf."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import model as jax_model
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, n, torch_model
from test_torch_graph_serving import _serve
from test_torch_serving import _COUNTERS, _jax_engine

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tengine = LazyModule("repro_torch.serving.engine")

ARCHS = ("granite_moe_1b", "qwen3_moe_235b")
# The published format (granite) or f32 (qwen3_moe, whose config names
# none), each at the published capacity factor.
_RUN = {"granite_moe_1b": dict(format_policy="int8"),
        "qwen3_moe_235b": {}}
_TOL = {"granite_moe_1b": MODEL_TOL["int8"],
        "qwen3_moe_235b": MODEL_TOL["fp32"]}
PAGE, SLOTS, CACHE_LEN, CHUNK = 8, 2, 96, 32
MAXP = CACHE_LEN // PAGE


def _cfgs(arch):
    """``arch.reduced()`` in both packages at capacity factor 1.25 and
    the run's format (JAX on its pallas backend)."""
    out = []
    for cfg in (jget_config(arch).reduced(),
                tconfigs.get_config(arch).reduced()):
        moe = dataclasses.replace(cfg.moe, capacity_factor=1.25)
        out.append(dataclasses.replace(cfg, moe=moe, **_RUN[arch]))
    return dataclasses.replace(out[0], gemm_backend="pallas"), out[1]


def _params(jcfg, tcfg, seed=0):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    return jp, tconvert.params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture
def drops(monkeypatch):
    """Counts the assignments the port's MoE layers drop: [assignments,
    dropped] over every ``apply_moe`` call while the test runs."""
    from repro_torch.models import moe
    seen = [0, 0]
    apply = moe.apply_moe

    def counting(x, p, cfg):
        _, keep, _ = moe.route_stats(x, p, cfg)
        seen[0] += keep.numel()
        seen[1] += int((~keep).sum())
        return apply(x, p, cfg)

    monkeypatch.setattr(moe, "apply_moe", counting)
    return seen


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, reduced):
    """Every field equal, full width and ``reduced()``, but the kernel
    backend's name; granite's published widths (24 layers, d_model 1024,
    16 heads on 8 kv heads of 64, vocab 49155; 32 experts, top 8, d_ff
    512, capacity factor 1.25) under int8 with ``moe_impl="a2a"``;
    qwen3_moe's QK-norm; ``n_params`` equal to JAX's; both names in
    ``PORTED_ARCHS``."""
    j, t = jget_config(arch), tconfigs.get_config(arch)
    assert arch in tconfigs.PORTED_ARCHS
    if arch == "granite_moe_1b":
        assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.hd,
                t.vocab) == (24, 1024, 16, 8, 64, 49155)
        assert (t.moe.n_experts, t.moe.top_k, t.moe.d_ff_expert,
                t.moe.capacity_factor) == (32, 8, 512, 1.25)
        assert (t.format_policy, t.moe_impl, t.tied_embeddings) == (
            "int8", "a2a", True)
    else:
        assert t.qk_norm and not t.tied_embeddings
    if reduced:
        j, t = j.reduced(), t.reduced()
        assert (t.n_layers, t.moe.n_experts, t.moe.top_k,
                t.moe.capacity_factor) == (2, 4, 2, 4.0)
    names = {f.name for f in dataclasses.fields(j)}
    assert names == {f.name for f in dataclasses.fields(t)}
    # Each package has its own MoEConfig class: compare its fields.
    assert dataclasses.asdict(j.moe) == dataclasses.asdict(t.moe)
    assert {k for k in names - {"moe"}
            if getattr(j, k) != getattr(t, k)} == {"gemm_backend"}
    assert t.n_params() == j.n_params()
    if arch == "granite_moe_1b" and not reduced:
        assert t.n_params() == 1334579200


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_the_moe_leaves(arch):
    """``params_from_jax`` carries the router, the experts' (E, D, F) and
    (E, F, D) tensors and qwen3's ``q_norm``/``k_norm``; the port's
    ``init_params`` builds the same tree (one draw of its own) and
    ``param_count`` equals JAX's element count."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    m, d = tcfg.moe, tcfg.d_model
    ffn = tp["layers"][1]["ffn"]
    assert ffn["router"].shape == (d, m.n_experts)
    assert ffn["gate"].shape == ffn["up"].shape == (m.n_experts, d,
                                                    m.d_ff_expert)
    assert ffn["down"].shape == (m.n_experts, m.d_ff_expert, d)
    np.testing.assert_array_equal(n(ffn["down"]),
                                  tree["groups"][0]["ffn"]["down"][1])
    mixer = tp["layers"][0]["mixer"]
    assert ("q_norm" in mixer) == ("k_norm" in mixer) == tcfg.qk_norm
    mine = torch_model.init_params(tcfg, seed=0, device="cpu")
    assert sorted(mine["layers"][0]["ffn"]) == sorted(ffn)
    assert sorted(mine["layers"][0]["mixer"]) == sorted(mixer)
    count = sum(int(np.size(a)) for a in jax.tree.leaves(tree))
    assert torch_model.param_count(tp) == torch_model.param_count(
        mine) == count


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    jcfg, _ = _cfgs(arch)
    loss = jax.jit(lambda p, b: jax_model.loss_fn(p, b, jcfg))
    fwd = jax.jit(lambda p, b: jax_model.forward(p, b, jcfg))
    chunk = {p0: jax.jit(lambda p, b, c, _p0=p0: jax_model.prefill_chunk(
        p, b, c, jcfg, pos0=_p0)) for p0 in (0, CHUNK)}
    dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
    return loss, fwd, chunk, dec


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, drops):
    """``forward`` logits over 2 x 32 tokens and ``loss_fn``'s loss, ce
    and aux (the MoE layers' Switch losses summed, above 0) within the
    run's tolerance; 64 tokens at capacity factor 1.25 drop
    assignments."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jloss, jfwd, _, _ = _jitted(arch)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 32),
                                               dtype=np.int32)
    jlogits, jaux = jfwd(jp, {"tokens": jnp.asarray(tokens)})
    logits, aux = torch_model.forward(tp, {"tokens": torch.as_tensor(
        tokens)}, tcfg)
    tol = _TOL[arch]
    np.testing.assert_allclose(n(logits), n(jlogits), rtol=tol, atol=tol)
    assert drops[1] > 0
    _, jm = jloss(jp, {"tokens": jnp.asarray(tokens)})
    _, m = torch_model.loss_fn(tp, {"tokens": torch.as_tensor(tokens)},
                               tcfg)
    assert float(m["aux"]) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=tol, atol=tol, err_msg=key)
    assert float(m["loss"]) == pytest.approx(float(m["ce"] + m["aux"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, drops):
    """A 64-token prompt into slot 1 in two 32-token chunks (the second
    reads the first's pages; capacity 24, assignments dropped), then
    three greedy decode steps with slot 0 idle (2 tokens a step, C = 8):
    logits of every call within the run's tolerance, equal greedy
    tokens."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    _, _, jchunk, jdec = _jitted(arch)
    kw = dict(num_pages=SLOTS * MAXP + 1, page_size=PAGE)
    jcache = jax_model.init_paged_cache(jcfg, SLOTS, CACHE_LEN, **kw)
    tcache = torch_model.init_paged_cache(tcfg, SLOTS, CACHE_LEN,
                                          device="cpu", **kw)
    table = np.full((SLOTS, MAXP), -1, np.int32)
    table[1] = 1 + np.arange(MAXP, dtype=np.int32)
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab, 2 * CHUNK,
                                               dtype=np.int32)
    tol = _TOL[arch]
    for p0 in (0, CHUNK):
        toks = prompt[None, p0:p0 + CHUNK]
        jl, jcache = jchunk[p0](jp, {"tokens": jnp.asarray(toks),
                                     "page_table": jnp.asarray(table[1:])},
                                jcache)
        tl, tcache = torch_model.prefill_chunk(
            tp, {"tokens": torch.as_tensor(toks),
                 "page_table": torch.as_tensor(table[1:])},
            tcache, tcfg, pos0=p0)
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"chunk at {p0}")
    assert drops[1] > 0
    tok = int(np.argmax(np.asarray(jl)[0]))
    assert tok == int(tl[0].argmax())
    for i in range(3):
        batch = dict(tokens=np.array([[0], [tok]], np.int32),
                     pos=np.array([0, 2 * CHUNK + i], np.int32),
                     page_table=table)
        jl, jcache = jdec(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          jcache)
        tl, tcache = torch_model.decode(
            tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcache,
            tcfg)
        np.testing.assert_allclose(n(tl[1]), n(jl[1]), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        tok = int(np.argmax(np.asarray(jl)[1]))
        assert tok == int(tl[1].argmax())


def _prompts(vocab):
    """Three 64-token prompts, the first and third sharing their first
    chunk (four pages, which the prefix cache serves to the third)."""
    rng = np.random.default_rng(6)
    head = rng.integers(0, vocab, CHUNK, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, CHUNK,
                                               dtype=np.int32)]),
            rng.integers(0, vocab, 2 * CHUNK, dtype=np.int32),
            np.concatenate([head, rng.integers(0, vocab, CHUNK,
                                               dtype=np.int32)])]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, drops):
    """Both engines synchronous, in their defaults otherwise (graph
    programs, the grouped decode q/k/v; the port's async default is held
    to JAX's in ``test_torch_async_engine.py``): 3 requests on 2 slots,
    32-token chunks (assignments dropped), the third served a chunk from
    the prefix cache: equal greedy streams, page tables after every step,
    prefix registrations and counters."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab)
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prefill_len=2 * CHUNK,
              page_size=PAGE, prefill_chunk=CHUNK, async_steps=False)
    jeng = _jax_engine(jp, jcfg, **kw)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", **kw)
    jout, jtables = _serve(jeng, JRequest, prompts)
    tout, ttables = _serve(teng, tengine.Request, prompts)
    assert drops[1] > 0
    assert sorted(tout) == sorted(jout) == [0, 1, 2]
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    assert ttables == jtables
    assert (teng.sched.pool.registrations()
            == jeng.sched.pool.registrations())
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_hit_pages"] > 0
    assert {k: tm[k] for k in _COUNTERS} == {k: jm[k] for k in _COUNTERS}
    teng.sched.pool.audit()


@pytest.mark.parametrize("spec_k", [1, 4])
def test_engine_refuses_speculation_on_moe(spec_k):
    """Speculation on a config with MoE layers is queued (ROADMAP A13):
    the engine raises rather than serving it unchecked."""
    _, tcfg = _cfgs("granite_moe_1b")
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        tengine.ServingEngine(params, tcfg, device="cpu", slots=2,
                              cache_len=64, prefill_len=32, page_size=8,
                              spec_k=spec_k)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_serving_params_dtypes(fmt):
    """Under bf16 the engine holds the experts and the dense projections
    in bf16 and the router in f32; under int8 every weight stays f32
    (quantized at each call, as JAX serves them)."""
    _, tcfg = _cfgs("qwen3_moe_235b")
    tcfg = dataclasses.replace(tcfg, format_policy=fmt)
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    served = tengine.serving_params(params, tcfg)
    op = torch.bfloat16 if fmt == "bf16" else torch.float32
    for lp in served["layers"]:
        ffn, mixer = lp["ffn"], lp["mixer"]
        assert ffn["router"].dtype == torch.float32
        assert {ffn[k].dtype for k in ("gate", "up", "down")} == {op}
        assert {mixer[k]["w"].dtype for k in "qkvo"} == {op}
        assert mixer["q_norm"]["scale"].dtype == torch.float32
    assert params["layers"][0]["ffn"]["gate"].dtype == torch.float32


def test_get_config_admits_the_moe_configs():
    """Both MoE configs resolve, and so does every other assigned config
    (``ARCH_NAMES``, all ten); ``test_torch_model.py`` holds the refusal
    of what stays unported."""
    for arch in ARCHS:
        assert tconfigs.get_config(arch).name == arch
    assert set(tconfigs.PORTED_ARCHS) == set(tconfigs.ARCH_NAMES)
    for arch in tconfigs.ARCH_NAMES:
        assert tconfigs.get_config(arch).name == arch
