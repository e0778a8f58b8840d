"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU, on the same numpy inputs made
from a seed, with the parameters carried across by
``repro_torch.convert.params_from_jax``.  JAX runs its experts on its
pallas backend in interpret mode, as its own kernel tests run them; the
port runs its plain versions.

Tolerances: route ids (and which assignments are dropped) exactly equal;
routing weights within 1e-6 and the aux loss within a relative 1e-6 (the
f32 router product and ``exp`` differ from XLA's in the last bit, so the
weights are not bit-equal); layer outputs within ``TOL["fp32"]`` (1e-5)
in f32 and the model tolerance (2e-2) in bf16 and int8, where the int32
accumulators of the experts' GEMMs over the same dispatch buffer are
exactly equal, as in ``test_torch_int8_engines.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import formats as jformats
from repro.core.geometry import BlockGeometry as JGeom
from repro.core.tile_state import SEW as JSEW
from repro.kernels.grouped_gemm import grouped_gemm_pallas
from repro.models import model as jax_model
from repro.models import moe as jmoe

from test_moe import _dense_reference
from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, TOL, n, t

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tconfigs = LazyModule("repro_torch.configs")
tformats = LazyModule("repro_torch.core.formats")
tmoe = LazyModule("repro_torch.models.moe")

# f32, bf16 (the compute dtype too) and the published int8.
_FMT = {"fp32": {}, "bf16": dict(format_policy="bf16",
                                 compute_dtype="bfloat16"),
        "int8": dict(format_policy="int8")}
_TOL = {"fp32": TOL["fp32"], "bf16": MODEL_TOL["bf16"],
        "int8": MODEL_TOL["int8"]}


def _cfgs(arch="granite_moe_1b", capacity_factor=None, **kw):
    """``arch.reduced()`` in both packages (JAX on its pallas backend),
    at ``capacity_factor`` when given (the reduced config's is 4.0)."""
    out = []
    for cfg in (jget_config(arch).reduced(),
                tconfigs.get_config(arch).reduced()):
        if capacity_factor is not None:
            kw["moe"] = dataclasses.replace(cfg.moe,
                                            capacity_factor=capacity_factor)
        out.append(dataclasses.replace(cfg, **kw))
    jcfg, tcfg = out
    return dataclasses.replace(jcfg, gemm_backend="pallas"), tcfg


def _params(jcfg, seed=0):
    """JAX ``init_moe`` and the same tensors as the port's leaves."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: t(v) for k, v in jp.items()}


def _inputs(d, tokens=64, skew=0.0, seed=1):
    """(2, tokens // 2, d) activations; ``skew`` adds one shared direction
    to every token, so the router favours the same experts and a
    capacity factor of 1.25 drops assignments."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, tokens // 2, d)) * 0.3
    x = x + skew * rng.standard_normal(d)
    return x.astype(np.float32)


def _both(x, cdt):
    """The same activations in JAX and in the port, in the compute
    dtype."""
    jx = jnp.asarray(x, jnp.dtype(cdt))
    return jx, t(np.asarray(jx))


def test_dense_reference_with_ample_capacity():
    """qwen3_moe_235b.reduced() at capacity factor 4.0 (no drops): the
    port's ``apply_moe`` equals JAX's dense top-k reference (every
    expert for every token, then the mask; ``tests/test_moe.py:22-41``)
    within its tolerance (2e-4), and its aux loss is positive."""
    jcfg, tcfg = _cfgs("qwen3_moe_235b")
    jp, tp = _params(jcfg)
    x = _inputs(jcfg.d_model, tokens=32)
    out, aux = tmoe.apply_moe(t(x), tp, tcfg)
    want = _dense_reference(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(n(out), n(want), rtol=2e-4, atol=2e-4)
    assert float(aux) > 0


@pytest.mark.parametrize("t_tokens", [1, 2, 4, 8, 16, 40, 64, 160, 512,
                                      1000, 4096])
@pytest.mark.parametrize("arch", ["granite_moe_1b", "qwen3_moe_235b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_moe_capacity_matches_jax(t_tokens, arch, reduced):
    """C for every token count, full width and reduced: granite's
    512-token chunk gets 160 slots an expert and its 4-slot decode step
    8 (the floor)."""
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    cap = tmoe.moe_capacity(t_tokens, tcfg)
    assert cap == jmoe.moe_capacity(t_tokens, jcfg)
    assert cap % 8 == 0 and cap >= 8
    if arch == "granite_moe_1b" and not reduced:
        assert {512: 160, 4: 8}.get(t_tokens, cap) == cap


def test_positions_in_expert_match_jax():
    """JAX's table (``tests/test_moe.py``) and 200 random assignments
    over 7 experts: each one's slot in its expert's queue, in order."""
    flat = [0, 1, 0, 2, 1, 0, 2, 2]
    got = tmoe._positions_in_expert(torch.as_tensor(flat), 3)
    assert got.tolist() == [0, 0, 1, 0, 1, 2, 1, 2]
    flat = np.random.default_rng(2).integers(0, 7, 200).astype(np.int32)
    got = tmoe._positions_in_expert(torch.as_tensor(flat), 7)
    want = jmoe._positions_in_expert(jnp.asarray(flat), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tied", [(2, 3), (0, 1, 2, 3), (1, 3)])
def test_forced_tie_keeps_jax_order(tied):
    """Router columns made identical give tokens equal probabilities for
    those experts; the top k keeps the lower expert first, as
    ``jax.lax.top_k`` does, and the weights split evenly."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    router = np.array(jp["router"])
    router[:, list(tied)] = router[:, [tied[0]]]
    router[:, list(tied)] += 1.0            # the tied experts lead
    x = np.abs(_inputs(jcfg.d_model, tokens=16)).reshape(-1, jcfg.d_model)
    jvals, jidx, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), jcfg)
    vals, idx, _ = tmoe._route(t(x), t(router), tcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [list(tied[:2])] * len(x)
    np.testing.assert_allclose(vals.numpy(), 0.5, rtol=0, atol=1e-7)


@pytest.mark.parametrize("skew", [0.0, 1.0])
@pytest.mark.parametrize("arch", ["granite_moe_1b", "qwen3_moe_235b"])
def test_routes_weights_and_aux_match_jax(arch, skew):
    """Expert ids exactly equal; weights within 1e-6; the Switch aux loss
    within a relative 1e-6; 64 tokens, skewed and not."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    x = _inputs(jcfg.d_model, skew=skew).reshape(-1, jcfg.d_model)
    jvals, jidx, jaux = jmoe._route(jnp.asarray(x), jp["router"], jcfg)
    vals, idx, aux = tmoe._route(t(x), tp["router"], tcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert aux.dtype == torch.float32 and aux.shape == ()


def _jax_keep(x2, jp, jcfg):
    """JAX's keep mask of ``apply_moe`` (``moe.py:117-121`` there)."""
    _, idx, _ = jmoe._route(x2, jp["router"], jcfg)
    pos = jmoe._positions_in_expert(idx.reshape(-1), jcfg.moe.n_experts)
    return np.asarray(pos < jmoe.moe_capacity(x2.shape[0], jcfg))


def test_capacity_1_25_drops_as_jax_does():
    """Reduced granite at its published capacity factor 1.25 (C = 40 for
    64 tokens) on skewed tokens: the port drops assignments (more than
    0), exactly JAX's; a dropped assignment adds nothing (the output
    equals the dense reference with the dropped weights zeroed), the
    output equals JAX's within fp32's tolerance and differs from the
    ample-capacity output."""
    jcfg, tcfg = _cfgs(capacity_factor=1.25)
    jp, tp = _params(jcfg)
    x = _inputs(jcfg.d_model, skew=1.0)
    x2 = x.reshape(-1, jcfg.d_model)
    idx, keep, cap = tmoe.route_stats(t(x), tp, tcfg)
    assert cap == 40
    assert int((~keep).sum()) > 0
    np.testing.assert_array_equal(keep.numpy(),
                                  _jax_keep(jnp.asarray(x2), jp, jcfg))
    out, _ = tmoe.apply_moe(t(x), tp, tcfg)
    jout, _ = jmoe.apply_moe(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(n(out), n(jout), rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    # The dense reference with each dropped assignment's weight zeroed.
    vals, _, _ = tmoe._route(t(x2), tp["router"], tcfg)
    xe = t(x2)
    g = torch.nn.functional.silu(torch.einsum("td,edf->etf", xe,
                                              tp["gate"]))
    u = torch.einsum("td,edf->etf", xe, tp["up"])
    out_e = torch.einsum("etf,efd->etd", g * u, tp["down"])
    w = vals * keep.reshape(vals.shape)
    rows = torch.arange(len(x2))
    dense = sum(w[:, j, None] * out_e[idx[:, j], rows]
                for j in range(tcfg.moe.top_k))
    np.testing.assert_allclose(n(out.reshape(-1, tcfg.d_model)), n(dense),
                               rtol=2e-4, atol=2e-4)
    ample, _ = tmoe.apply_moe(t(x), tp, _cfgs(capacity_factor=4.0)[1])
    assert not torch.allclose(out, ample)


def _jgeom():
    return JGeom(bm=64, bn=128, bk=128, split_k=1, n_acc=1,
                 transposed_b=False, sew_i=JSEW.E8, sew_o=JSEW.E32,
                 policy="mte")


def _jax_buffer(x2, jp, jcfg):
    """JAX's (E, C, D) dispatch buffer (``moe.py:113-126`` there)."""
    m = jcfg.moe
    _, idx, _ = jmoe._route(x2, jp["router"], jcfg)
    cap = jmoe.moe_capacity(x2.shape[0], jcfg)
    flat_e = idx.reshape(-1)
    pos = jmoe._positions_in_expert(flat_e, m.n_experts)
    safe = jnp.where(pos < cap, pos, cap)
    buf = jnp.zeros((m.n_experts, cap, x2.shape[1]), x2.dtype)
    return buf.at[flat_e, safe].set(jnp.repeat(x2, m.top_k, axis=0),
                                    mode="drop")


@pytest.mark.parametrize("skew", [0.0, 1.0])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
def test_apply_moe_matches_jax_pallas(fmt, skew, monkeypatch):
    """Reduced granite at capacity factor 1.25 over 64 tokens, in f32,
    bf16 and int8: the port's dispatch buffer equals JAX's bit for bit;
    under int8 its quantized operands and the int32 accumulators of the
    gate and up GEMMs over it (the port's plan, the JAX Pallas kernel in
    interpret mode) are exactly equal; the output within the format's
    tolerance and the aux loss within a relative 1e-6."""
    jcfg, tcfg = _cfgs(capacity_factor=1.25, **_FMT[fmt])
    jp, tp = _params(jcfg)
    jx, tx = _both(_inputs(jcfg.d_model, skew=skew), jcfg.compute_dtype)
    seen = []
    ffn = tmoe._expert_ffn
    monkeypatch.setattr("repro_torch.models.moe._expert_ffn",
                        lambda buf, p, cfg: seen.append(buf) or ffn(buf, p,
                                                                    cfg))
    out, aux = tmoe.apply_moe(tx, tp, tcfg)
    jout, jaux = jmoe.apply_moe(jx, jp, jcfg)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    jbuf = _jax_buffer(jx.reshape(-1, jcfg.d_model), jp, jcfg)
    np.testing.assert_array_equal(n(seen[0]), n(jbuf))
    if fmt == "int8":
        jfmt, tfmt = jformats.FORMATS[fmt], tformats.FORMATS[fmt]
        for name in ("gate", "up"):
            jxq, jwq, _, _ = jformats.quantize_operands(jbuf, jp[name], jfmt)
            xq, wq, _, _ = tformats.quantize_operands(seen[0], tp[name],
                                                      tfmt)
            np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
            np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
            g, c, k = xq.shape
            plan = tautotune.get_plan(c, wq.shape[2], k, torch.int8,
                                      torch.int32, fmt=fmt, group=g)
            acc = tautotune.execute_plan(plan, xq, wq)
            want = grouped_gemm_pallas(jxq, jwq, geom=_jgeom(),
                                       out_dtype=jnp.int32, interpret=True)
            assert acc.dtype == torch.int32
            np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
    tol = _TOL[fmt]
    np.testing.assert_allclose(n(out), n(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("impl", ["a2a", "scatter"])
def test_dispatch_takes_the_scatter_path_without_a_mesh(impl):
    """granite's published ``moe_impl="a2a"`` with no device mesh: JAX's
    ``_moe_dispatch`` runs its ``apply_moe`` (bit for bit), and so does
    the port's ``dispatch``; the two agree within fp32's tolerance; an
    unknown ``moe_impl`` raises."""
    jcfg, tcfg = _cfgs(moe_impl=impl)
    assert jget_config("granite_moe_1b").moe_impl == "a2a"
    assert tconfigs.get_config("granite_moe_1b").moe_impl == "a2a"
    jp, tp = _params(jcfg)
    x = _inputs(jcfg.d_model)
    jy, jaux = jax_model._moe_dispatch(jnp.asarray(x), jp, jcfg)
    jz, jaux2 = jmoe.apply_moe(jnp.asarray(x), jp, jcfg)
    np.testing.assert_array_equal(np.asarray(jy), np.asarray(jz))
    y, aux = tmoe.dispatch(t(x), tp, tcfg)
    z, aux2 = tmoe.apply_moe(t(x), tp, tcfg)
    assert torch.equal(y, z) and torch.equal(aux, aux2)
    np.testing.assert_allclose(n(y), n(jy), rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    with pytest.raises(ValueError, match="moe_impl"):
        tmoe.dispatch(t(x), tp, dataclasses.replace(tcfg, moe_impl="ring"))


def test_init_moe_distributions():
    """Shapes and scales of the port's own draw: router (D, E) and gate/up
    N(0, 1/D), down N(0, 1/F), from the generator given."""
    _, tcfg = _cfgs()
    m, d = tcfg.moe, tcfg.d_model
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, tcfg)
    assert p["router"].shape == (d, m.n_experts)
    assert p["gate"].shape == p["up"].shape == (m.n_experts, d,
                                                m.d_ff_expert)
    assert p["down"].shape == (m.n_experts, m.d_ff_expert, d)
    for name, scale in (("gate", d ** -0.5), ("up", d ** -0.5),
                        ("down", m.d_ff_expert ** -0.5)):
        assert abs(float(p[name].std()) - scale) < 0.05 * scale, name
    again = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert all(torch.equal(p[k], again[k]) for k in p)
