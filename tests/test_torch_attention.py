"""The port's spatial attention core and the variant blocks against the JAX
package: the plain core against the Pallas flash kernel (interpret mode)
and the einsum core, the autograd.Function on the CPU, and
``SelfAttention2d``, ``ChannelAttention`` and ``StyleGate`` against the
flax modules on converted weights with non-zero gains. Inputs from a numpy
seed; JAX on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.models.attention import (
    ChannelAttention as JaxChannelAttention,
    SelfAttention2d as JaxSelfAttention2d,
    StyleGate as JaxStyleGate,
    flash_spatial_attention,
)
from gan_variant_research_tpu_torch.convert import _dense_to_linear, _hwio_to_oihw
from gan_variant_research_tpu_torch.core.precision import FP32_POLICY
from gan_variant_research_tpu_torch.models.attention import (
    ChannelAttention,
    SelfAttention2d,
    StyleGate,
    einsum_attention,
)
from gan_variant_research_tpu_torch.ops.kernels import spatial_attention as sa
from gan_variant_research_tpu_torch.train.cut_trainer import build_generator

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(shape, seed=0):
    b, n, dqk, dv = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, dqk)).astype(np.float32),
            rng.standard_normal((b, n, dqk)).astype(np.float32),
            rng.standard_normal((b, n, dv)).astype(np.float32),
            rng.standard_normal((b, n, dv)).astype(np.float32))


def _port_grads(fn, q, k, v, g, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = fn(*leaves)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(g).to(dtype))
    return o.detach().float().numpy(), [t.float().numpy() for t in grads]


def _rel_to_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_plain_core_matches_jax_flash_kernel_in_interpret_mode():
    """The shape test_attention_variants.py runs the Pallas kernel at:
    (B, n, d_qk, d_v) = (2, 1024, 16, 128), float32."""
    import jax.experimental.pallas.tpu as pltpu

    q, k, v, g = _qkv((2, 1024, 16, 128))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(flash_spatial_attention, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
        want_grads = vjp(jnp.asarray(g))
    got, got_grads = _port_grads(sa.spatial_attention, q, k, v, g)
    # float32 both sides; the softmax and the sums run in another order
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", got_grads, want_grads):
        assert _rel_to_max(a, np.asarray(b)) <= 1e-4, name


def _jax_flash_blocks(q, k, v, block):
    """flash_spatial_attention's adaptation of the library kernel (q, k
    zero-padded to 128, v in 128-wide heads that share the weights), with
    every block size ``block``: an n that its 512/1024 blocks do not tile."""
    from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, flash_attention

    b, n, inner = q.shape
    heads = v.shape[-1] // 128
    qh, kh = (jnp.broadcast_to(jnp.pad(t, ((0, 0), (0, 0), (0, 128 - inner)))[:, None],
                               (b, heads, n, 128)) for t in (q, k))
    vh = v.reshape(b, n, heads, 128).transpose(0, 2, 1, 3)
    sizes = BlockSizes(**{f: 1 if f == "block_b" else block
                          for f in BlockSizes.__dataclass_fields__})
    o = flash_attention(qh, kh, vh, causal=False, sm_scale=1.0, block_sizes=sizes)
    return o.transpose(0, 2, 1, 3).reshape(b, n, heads * 128)


FLASH_BWD_CASES = [((1, 512, 16, 128), None), ((1, 640, 32, 256), 128)]


@functools.cache
def _jax_flash_bwd_bf16(shape, block):
    """The Pallas flash backward run in bf16 in interpret mode: at (1, 512)
    flash_spatial_attention with one 128-wide head, at n = 640 the library
    kernel in 128-blocks with two heads. Returns the bf16 inputs (q, k, v,
    do) as torch tensors, the forward's residuals lse (of the logits) and
    di = sum(o * do) of the bf16 o, and the library's (dq, dk, dv) in
    float32 numpy."""
    import jax.experimental.pallas.tpu as pltpu

    q, k, v, g = _qkv(shape, seed=4)
    q, k = q * 0.5, k * 0.5
    fn = (flash_spatial_attention if block is None
          else functools.partial(_jax_flash_blocks, block=block))
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
        want = vjp(jnp.asarray(g, jnp.bfloat16))
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    lse = torch.logsumexp(tq.double() @ tk.double().transpose(1, 2), -1).float()
    di = (torch.from_numpy(np.array(o.astype(jnp.float32))) * tg.float()).sum(-1)
    return (tq, tk, tv, tg), lse, di, [np.asarray(w.astype(jnp.float32)) for w in want]


@pytest.mark.parametrize("shape, block", FLASH_BWD_CASES)
def test_bf16_contract_backward_matches_jax_flash_kernel(shape, block):
    """The contract versions of dK/dV and dQ (p and ds rounded to bf16, sums
    in float64) against the Pallas flash backward run in bf16 in interpret
    mode on the same bf16 inputs: flash_spatial_attention at (1, 512) with
    one 128-wide head, and the library kernel in 128-blocks at n = 640 with
    two heads. Both sides round each output once, and the library rounds ds
    once per head (twice at d_v = 256) where the contract rounds it once:
    the tolerance is one bf16 rounding of each output's largest value."""
    (tq, tk, tv, tg), lse, di, want = _jax_flash_bwd_bf16(shape, block)
    dk, dv = sa.spatial_attention_dkv_contract(tq, tk, tv, tg, lse, di)
    dq = sa.spatial_attention_dq_contract(tq, tk, tv, tg, lse, di)
    for name, got, w in zip("qkv", (dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - w).max()
        assert err <= _bf16_ulp(np.abs(w).max()), (name, err)


def _wgmma_dq_split(q, k, v, do, lse, di, mask_keys=True):
    """The bf16 wgmma kernel of csrc/spatial_attention_dq.cu written out in
    plain torch: blocks of 128 queries of one image (q and do zero past n,
    lse +inf and di 0 there, as the kernel loads them); tiles of 64 keys, k
    and v zero past n within the image (TMA's fill); s = q k^T and dp = do
    v^T in float32; p = exp2(s log2e - lse log2e), keys past n masked to 0
    by index (unless ``mask_keys`` is False); ds = p (dp - di) rounded to
    bf16 element by element; dQ += ds k summed in float32 tile by tile in
    key order. Returns that float32 value, which the epilogue casts once to
    bf16; every row is written by exactly one block."""
    log2e = 1.4426950408889634
    b, n, dqk = q.shape
    dv = v.shape[2]
    bq, bk = 128, 64
    nk = -(-n // bk)
    out = torch.zeros((b, n, dqk))
    written = torch.zeros((b, n), dtype=torch.int64)
    for img in range(b):
        kt, vt = torch.zeros((nk * bk, dqk)), torch.zeros((nk * bk, dv))
        kt[:n], vt[:n] = k[img].float(), v[img].float()
        for q0 in range(0, n, bq):
            m = min(bq, n - q0)
            qb, dob = torch.zeros((bq, dqk)), torch.zeros((bq, dv))
            qb[:m], dob[:m] = q[img, q0:q0 + m].float(), do[img, q0:q0 + m].float()
            lb, db = torch.full((bq,), float("inf")), torch.zeros(bq)
            lb[:m], db[:m] = lse[img, q0:q0 + m] * log2e, di[img, q0:q0 + m]
            acc = torch.zeros((bq, dqk))
            for j in range(nk):
                keys = slice(j * bk, (j + 1) * bk)
                s = qb @ kt[keys].T
                dp = dob @ vt[keys].T
                if mask_keys:
                    s[:, torch.arange(j * bk, (j + 1) * bk) >= n] = float("-inf")
                p = torch.exp2(s * log2e - lb[:, None])
                ds = (p * (dp - db[:, None])).to(torch.bfloat16).float()
                acc += ds @ kt[keys]
            out[img, q0:q0 + m] = acc[:m]
            written[img, q0:q0 + m] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("shape, block", FLASH_BWD_CASES)
def test_wgmma_dq_split_matches_jax_flash_kernel(shape, block):
    """The dQ kernel's blocks, key tiles, masked p, ds rounded once and
    float32 sums in key order give the Pallas flash backward's dq (bf16, in
    interpret mode) on the same bf16 inputs, within one bf16 rounding of its
    largest value (the library rounds ds once per head)."""
    (tq, tk, tv, tg), lse, di, want = _jax_flash_bwd_bf16(shape, block)
    got = _wgmma_dq_split(tq, tk, tv, tg, lse, di).to(torch.bfloat16).float().numpy()
    assert np.abs(got - want[0]).max() <= _bf16_ulp(np.abs(want[0]).max())


def _bf16_bwd_inputs(shape, seed, logit_shift=0.0):
    """bf16 (q, k, v, do) from a numpy seed (q, k scaled by 0.5) and the
    forward's lse and di. ``logit_shift`` (-100 at most) adds one column,
    q 10 and k logit_shift / 10, in place of the last: every logit, and so
    lse, moves by logit_shift."""
    q, k, v, g = _qkv(shape, seed=seed)
    q, k = q * 0.5, k * 0.5
    if logit_shift:
        q[..., -1], k[..., -1] = 10.0, logit_shift / 10
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    o, lse = sa.spatial_attention_forward(tq, tk, tv)
    return (tq, tk, tv, tg), lse, (o.float() * tg.float()).sum(-1)


def _held_to_contract(got, args, lse, di):
    want = sa.spatial_attention_dq_contract(*args, lse, di).float()
    err = float((got.to(torch.bfloat16).float() - want).abs().max())
    assert err <= float(_bf16_ulp(want.abs().max().numpy())), err


@pytest.mark.parametrize("n", [127, 129])
def test_wgmma_dq_split_matches_contract_at_ragged_n(n):
    """Three images whose n is not a multiple of the 64-key tile or the
    128-query block, d_qk 24 (padded to 32 by the kernel): the split within
    one bf16 rounding of the contract version's largest value."""
    args, lse, di = _bf16_bwd_inputs((3, n, 24, 72), seed=7)
    _held_to_contract(_wgmma_dq_split(*args, lse, di), args, lse, di)


def test_wgmma_dq_split_needs_the_key_mask():
    """With every logit shifted by -100, lse < -88: a zero-filled key past n
    (s = 0) then has p = exp2(-lse log2e) = inf in float32, and ds k = inf x 0
    is NaN. Masking p by key index keeps dQ finite and on the contract; the
    zero fill alone does not."""
    args, lse, di = _bf16_bwd_inputs((2, 129, 24, 40), seed=8, logit_shift=-100.0)
    assert (lse < -88).all()
    assert _wgmma_dq_split(*args, lse, di, mask_keys=False).isnan().any()
    got = _wgmma_dq_split(*args, lse, di)
    assert torch.isfinite(got).all()
    _held_to_contract(got, args, lse, di)


@pytest.mark.parametrize("acc", [torch.float64, torch.float32])
def test_contract_versions_in_float32_are_the_references(acc):
    """For float32 inputs the contract rounds nothing: it is the plain
    backward up to the order of its sums."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkv((2, 96, 24, 40), seed=5))
    o, lse = sa.spatial_attention_forward(q, k, v)
    di = (o * g).sum(-1)
    got = (sa.spatial_attention_dq_contract(q, k, v, g, lse, di, acc),
           *sa.spatial_attention_dkv_contract(q, k, v, g, lse, di, acc))
    want = (sa.spatial_attention_dq_reference(q, k, v, g, lse, di),
            *sa.spatial_attention_dkv_reference(q, k, v, g, lse, di))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel_to_max(a.numpy(), b.numpy()) <= 1e-5


def test_smoke_float64_core_is_autograd_in_float64():
    """chip_smoke.py's float64 yardstick of the bf16 backward kernels
    (``attention_grads_float64``, one image at a time through
    ``per_image``) is autograd of softmax(q k^T) v in float64, and the bf16
    contract versions pass its check against themselves."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    q, k, v, g = (torch.from_numpy(a).double() for a in _qkv((3, 40, 8, 24), seed=6))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = torch.softmax(leaves[0] @ leaves[1].transpose(1, 2), -1) @ leaves[2]
    want = torch.autograd.grad(o, leaves, g)
    got = cs.per_image(cs.attention_grads_float64, q, k, v, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    bq, bk, bv, bg = (t.to(torch.bfloat16) for t in (q, k, v, g))
    o, lse = sa.spatial_attention_forward(bq, bk, bv)
    di = (o.float() * bg.float()).sum(-1)
    dk, dv = sa.spatial_attention_dkv_contract(bq, bk, bv, bg, lse, di)
    plain = sa.spatial_attention_dkv_reference(bq, bk, bv, bg, lse, di)
    truth = sa.spatial_attention_dkv_reference(*(t.float() for t in (bq, bk, bv, bg)), lse, di)
    for a, p, t in zip((dk, dv), plain, truth):
        assert cs.bf16_backward_check(a, a, p, t)["ok"]


def _jax_einsum_core(q, k, v):
    """SelfAttention2d's einsum path (attention.py:188-191)."""
    logits = jnp.einsum("bqc,bkc->bqk", q, k, preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
    return jnp.einsum("bqk,bkc->bqc", attn, v)


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7 * 9, 8, 24), (1, 5 * 3, 16, 40)])
def test_plain_core_matches_jax_einsum_core(shape, dtype):
    q, k, v, g = _qkv(shape, seed=1)
    jd = JAX_DTYPES[dtype]
    args = [jnp.asarray(a, jd) for a in (q, k, v)]
    want, vjp = jax.vjp(_jax_einsum_core, *args)
    want = np.asarray(want.astype(jnp.float32))
    got, got_grads = _port_grads(sa.spatial_attention, q, k, v, g, dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
        want_grads = vjp(jnp.asarray(g))
        for name, a, b in zip("qkv", got_grads, want_grads):
            assert _rel_to_max(a, np.asarray(b)) <= 1e-5, name
    else:
        # the same rounding points (bf16 weights, one cast of a float32 sum):
        # one bf16 ulp apart where the sums' order tips a rounding
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_function_on_the_cpu_is_autograd_of_the_plain_version():
    q, k, v, g = _qkv((2, 50, 8, 16), seed=2)
    got, got_grads = _port_grads(sa.spatial_attention, q, k, v, g)
    want, want_grads = _port_grads(sa.spatial_attention_reference, q, k, v, g)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    q, k, v, g = (torch.from_numpy(a) for a in _qkv((2, 33, 8, 16), seed=3))
    before = (sa.ATTN_LAUNCHES, sa.ATTN_DKV_LAUNCHES, sa.ATTN_DQ_LAUNCHES)
    o, lse = sa.spatial_attention_forward(q, k, v)
    torch.testing.assert_close(o, sa.spatial_attention_reference(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(lse, torch.logsumexp(q @ k.transpose(1, 2), -1))
    di = (o * g).sum(-1)
    dk, dv = sa.spatial_attention_dkv(q, k, v, g, lse, di)
    dq = sa.spatial_attention_dq(q, k, v, g, lse, di)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(sa.spatial_attention_reference(*leaves), leaves, g)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (sa.ATTN_LAUNCHES, sa.ATTN_DKV_LAUNCHES, sa.ATTN_DQ_LAUNCHES) == before


@pytest.mark.parametrize("d_qk, d_v, want", [
    (32, 256, ("direct", 32, 256, 1)), (8, 8, ("direct", 8, 8, 1)),
    (4, 32, ("padded", 8, 32, 1)), (20, 160, ("padded", 24, 160, 1)),
    (4, 36, ("padded", 8, 40, 1)), (1, 1, ("padded", 8, 8, 1)),
    (48, 384, ("split", 48, 192, 2)), (20, 384, ("split", 24, 192, 2)),
    (8, 257, ("split", 8, 136, 2)), (16, 512, ("split", 16, 256, 2)),
    (64, 1000, ("split", 64, 256, 4)), (72, 32, ("padded", 128, 32, 1)),
    (80, 640, ("split", 128, 216, 3)), (128, 256, ("direct", 128, 256, 1)),
    (128, 1024, ("split", 128, 256, 4)), (72, 576, ("split", 128, 192, 3)),
    (136, 1088, ("einsum", 136, 1088, 1)), (160, 1280, ("einsum", 160, 1280, 1))])
def test_attention_route_is_picked_by_shape(d_qk, d_v, want):
    """d_qk and the chunk width in multiples of 8 (at least 8), d_qk past 64
    padded to the kernels' 128 instance (as the JAX flash path pads to its
    128-wide head), chunks of at most 256 covering d_v; past d_qk 128 the
    JAX package's einsum core, which takes d_v whole."""
    assert sa.attention_route(d_qk, d_v) == want
    route, dqk, width, chunks = want
    if route == "einsum":
        assert (dqk, width, chunks) == (d_qk, d_v, 1)
        return
    assert dqk in (*range(8, 65, 8), 128)
    assert width % 8 == 0 and width <= 256 and width * chunks >= d_v
    assert width * (chunks - 1) < d_v


@pytest.mark.parametrize("d_qk, want", [(8, 256), (64, 256), (128, 128)])
def test_backward_width_is_the_instances(d_qk, want):
    """The backward kernels take d_v up to 256 on the d_qk 16/32/64
    instances and up to 128 on the 128 one; the wrappers refuse wider."""
    assert sa.backward_width(d_qk) == want
    q = torch.zeros(1, 64, d_qk)
    sa._check_cuda(q, q, torch.zeros(1, 64, want), max_dv=sa.backward_width(d_qk))
    with pytest.raises(ValueError, match="d_v"):
        sa._check_cuda(q, q, torch.zeros(1, 64, want + 8), max_dv=sa.backward_width(d_qk))


@pytest.mark.parametrize("shape", [(2, 50, 4, 36), (2, 33, 20, 384), (1, 40, 4, 384),
                                   (2, 21, 20, 36), (1, 17, 48, 384)])
def test_routed_core_matches_the_plain_core(shape):
    """The padded and split routes' arithmetic (the kernels' wrappers run
    their plain versions on the CPU) against the plain core on the unpadded,
    unsplit inputs, float32, forward and gradients; on the CPU nothing is
    counted as launched."""
    q, k, v, g = _qkv(shape, seed=4)
    before = dict(sa.ATTN_ROUTE_LAUNCHES)
    got, got_grads = _port_grads(sa.spatial_attention, q, k, v, g)
    want, want_grads = _port_grads(sa.spatial_attention_reference, q, k, v, g)
    assert got.shape == want.shape == shape[:2] + shape[3:]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for name, a, b in zip("qkv", got_grads, want_grads):
        # the split route sums dK and dQ over the chunks: float32 sums in
        # another order
        assert a.shape == b.shape
        assert _rel_to_max(a, b) <= 1e-5, name
    assert sa.ATTN_ROUTE_LAUNCHES == before


@pytest.mark.parametrize("shape", [(2, 33, 20, 384), (2, 50, 4, 36)])
def test_routed_core_in_bf16_keeps_the_plain_rounding(shape):
    """bf16: the forward's columns round where the plain core's do (the
    same bits); dV too. dK and dQ of the split route are the sum of each
    chunk's bf16 result, cast once: within one bf16 rounding of each chunk's
    largest value plus one of the sum's of the unsplit plain gradient."""
    q, k, v, g = _qkv(shape, seed=5)
    got, got_grads = _port_grads(sa.spatial_attention, q, k, v, g, torch.bfloat16)
    want, want_grads = _port_grads(sa.spatial_attention_reference, q, k, v, g, torch.bfloat16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_grads[2], want_grads[2])
    chunks = sa.attention_route(shape[2], shape[3])[3]
    for a, b in zip(got_grads[:2], want_grads[:2]):
        tol = (chunks + 1) * _bf16_ulp(np.abs(b).max())
        assert np.abs(a - b).max() <= tol


def test_split_route_takes_each_chunks_own_di():
    """The split backward equals autograd of the core run on each chunk
    alone, dK and dQ summed: each chunk's di is its own sum of o do."""
    q, k, v, g = (torch.from_numpy(a).double() for a in _qkv((1, 24, 8, 300), seed=6))
    _, _, width, chunks = sa.attention_route(8, 300)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    dq, dk, dv = torch.autograd.grad(sa.spatial_attention(*leaves), leaves, g.float())
    ql, kl = q.clone().requires_grad_(), k.clone().requires_grad_()
    vp = torch.nn.functional.pad(v, (0, width * chunks - 300))
    gp = torch.nn.functional.pad(g, (0, width * chunks - 300))
    want_q = want_k = 0
    for c in range(chunks):
        sl = slice(c * width, (c + 1) * width)
        o = torch.softmax(ql @ kl.transpose(1, 2), -1) @ vp[..., sl]
        a, b = torch.autograd.grad(o, (ql, kl), gp[..., sl])
        want_q, want_k = want_q + a, want_k + b
    assert _rel_to_max(dq.numpy(), want_q.numpy()) <= 1e-5
    assert _rel_to_max(dk.numpy(), want_k.numpy()) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 512, 48, 384), (1, 512, 20, 256), (1, 1024, 128, 256),
                                   (1, 1024, 80, 640)])
def test_routed_core_matches_jax_flash_kernel_in_interpret_mode(shape):
    """The split route at the ngf-96 variant's widths (d_qk 48, d_v 384 in
    2 x 192), the padded route at d_qk 20, the d_qk-128 instance direct at
    the ngf-256 variant's d_qk (d_v 256, its backward in 2 x 128) and at
    the ngf-160 variant's widths (d_qk 80 padded to 128, d_v 640 split in
    3 x 216, each chunk's backward in 128 + 88) against the Pallas flash
    kernel (interpret mode) that the JAX variant runs there, float32,
    forward and gradients, to the unrouted core's tolerances."""
    import jax.experimental.pallas.tpu as pltpu

    q, k, v, g = _qkv(shape, seed=7)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(flash_spatial_attention, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
        want_grads = vjp(jnp.asarray(g))
    got, got_grads = _port_grads(sa.spatial_attention, q, k, v, g)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", got_grads, want_grads):
        assert _rel_to_max(a, np.asarray(b)) <= 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7 * 9, 4, 36), (1, 5 * 3, 20, 160),
                                   (1, 4 * 6, 48, 384)])
def test_routed_core_matches_jax_einsum_core(shape, dtype):
    """The padded and split routes against SelfAttention2d's einsum path,
    which the JAX package runs where d_v is no multiple of 128: float32
    forward and gradients; bf16 forward within one rounding."""
    q, k, v, g = _qkv(shape, seed=8)
    jd = JAX_DTYPES[dtype]
    want, vjp = jax.vjp(_jax_einsum_core, *(jnp.asarray(a, jd) for a in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    got, got_grads = _port_grads(sa.spatial_attention, q, k, v, g, dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
        for name, a, b in zip("qkv", got_grads, vjp(jnp.asarray(g))):
            assert _rel_to_max(a, np.asarray(b)) <= 1e-5, name
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("shape, route, chunks", [
    ((2, 16, 8, 32), "direct", 1), ((2, 16, 4, 36), "padded", 1),
    ((1, 16, 48, 384), "split", 2), ((1, 16, 8, 600), "split", 3)])
def test_each_forward_launch_is_counted_under_the_callers_route(monkeypatch, shape, route,
                                                               chunks):
    """``spatial_attention`` hands its route to the forward wrapper, which
    counts it where it launches: once per chunk, under the route the shape
    picks."""
    seen = []
    forward = sa.spatial_attention_forward

    def recorder(q, k, v, route="direct"):
        seen.append((route, tuple(q.shape), tuple(v.shape)))
        return forward(q, k, v, route)

    monkeypatch.setattr(sa, "spatial_attention_forward", recorder)
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(shape, seed=9))
    sa.spatial_attention(q, k, v)
    _, dqk, width, _ = sa.attention_route(shape[2], shape[3])
    assert seen == [(route, (shape[0], shape[1], dqk), (shape[0], shape[1], width))] * chunks


@pytest.mark.parametrize("route", ["plain", "einsum"])
def test_forward_wrapper_refuses_an_unknown_route(route):
    """Only the kernels' routes: the einsum core launches no kernel."""
    q = torch.zeros(1, 16, 8)
    with pytest.raises(ValueError, match="route"):
        sa.spatial_attention_forward(q, q, q, route=route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_einsum_route_matches_jax_einsum_core(dtype):
    """d_qk 160 (the ngf-320 variant's d_qk, d_v 1280): the JAX package runs
    its einsum core there, and so does the port (``einsum_attention``).
    float32: forward to 1e-6 + 1e-5 relative, gradients to 1e-5 of their
    largest value (sums in another order); bf16: the same rounding points,
    the forward within one bf16 rounding of each value, or of 1e-6 of the
    largest where a sum of 256 float32 terms cancels to near 0 and their
    order moves it."""
    shape = (1, 256, 160, 1280)
    q, k, v, g = _qkv(shape, seed=12)
    q, k = q * 0.25, k * 0.25
    jd = JAX_DTYPES[dtype]
    want, vjp = jax.vjp(_jax_einsum_core, *(jnp.asarray(a, jd) for a in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    before = dict(sa.ATTN_ROUTE_LAUNCHES)
    got, got_grads = _port_grads(einsum_attention, q, k, v, g, dtype)
    assert sa.ATTN_ROUTE_LAUNCHES == before   # counted on the card only
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
        for name, a, b in zip("qkv", got_grads, vjp(jnp.asarray(g))):
            assert _rel_to_max(a, np.asarray(b)) <= 1e-5, name
    else:
        tol = np.maximum(_bf16_ulp(want), 1e-6 * np.abs(want).max())
        assert (np.abs(got - want) <= tol).all()


def test_kernel_core_refuses_the_einsum_route():
    q = torch.zeros(1, 16, 160)
    with pytest.raises(ValueError, match="einsum"):
        sa.spatial_attention(q, q, torch.zeros(1, 16, 32))


@pytest.mark.parametrize("channels, core", [(1024, "kernels"), (1280, "einsum")])
def test_self_attention_picks_its_core_by_d_qk(monkeypatch, channels, core):
    """d_qk = C / 8 up to 128 takes the kernels' core, past it the einsum
    core, on the CPU as on the card."""
    seen = []
    monkeypatch.setattr(sa, "spatial_attention",
                        lambda q, k, v: seen.append("kernels") or einsum_attention(q, k, v))
    import gan_variant_research_tpu_torch.models.attention as attention

    real = attention.einsum_attention
    monkeypatch.setattr(attention, "einsum_attention",
                        lambda q, k, v: seen.append("einsum") or real(q, k, v))
    mod = SelfAttention2d(channels, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mod(torch.zeros(1, 2, 2, channels))
    assert seen == [core]


@pytest.mark.parametrize("shape, message", [
    ((1, 64, 4, 32), "d_qk"), ((1, 64, 136, 32), "d_qk"), ((1, 64, 12, 32), "d_qk"),
    ((1, 64, 8, 264), "d_v"), ((1, 64, 8, 20), "d_v")])
def test_kernel_limits_are_checked_before_a_launch(shape, message):
    b, n, dqk, dv = shape
    q = torch.zeros(b, n, dqk)
    with pytest.raises(ValueError, match=message):
        sa._check_cuda(q, q, torch.zeros(b, n, dv))


def test_wrappers_refuse_mismatched_inputs():
    q = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="B, n"):
        sa.spatial_attention(q, torch.zeros(2, 15, 8), torch.zeros(2, 16, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sa.spatial_attention(q, q, torch.zeros(2, 16, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="lse"):
        sa.spatial_attention_dq(q, q, q, q, torch.zeros(2, 15), torch.zeros(2, 16))


# --------------------------------------------------------------------------- #
# the modules, with converted weights and non-zero gains


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _load(module, flat):
    missing, unexpected = module.load_state_dict(
        {k: torch.as_tensor(v) for k, v in flat.items()}, strict=True)
    assert not missing and not unexpected


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _compare(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    # float32: convs and sums in another order; bf16: the same rounding
    # points, a few ulps of the output's scale where an order tips one
    assert _rel_to_max(got, want) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_attention_matches_flax(dtype):
    c = 32
    x = _x((2, 6, 7, c), 4)
    jmod = JaxSelfAttention2d(c, flash=False, dtype=JAX_DTYPES[dtype])
    params = _np_tree(jmod.init(jax.random.PRNGKey(0),
                                jnp.asarray(x, JAX_DTYPES[dtype]))["params"])
    params["gamma"] = np.float32(0.5)
    flat = {f"{m}.{leaf}": fn(params[m][jl]) for m in ("query", "key", "value", "out")
            for jl, (leaf, fn) in {"kernel": ("weight", _hwio_to_oihw),
                                   "bias": ("bias", torch.from_numpy)}.items()}
    flat["gamma"] = torch.tensor(0.5)
    mod = SelfAttention2d(c, dtype=dtype)
    _load(mod, flat)
    want = jmod.apply({"params": params}, jnp.asarray(x, JAX_DTYPES[dtype]))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_attention_matches_flax(dtype):
    c = 32
    x = _x((2, 5, 5, c), 5)
    jmod = JaxChannelAttention(c, dtype=JAX_DTYPES[dtype])
    params = _np_tree(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    rng = np.random.default_rng(6)
    params["fc2"]["kernel"] = rng.standard_normal(params["fc2"]["kernel"].shape).astype(np.float32)
    params["fc2"]["bias"] = rng.standard_normal(params["fc2"]["bias"].shape).astype(np.float32)
    mod = ChannelAttention(c, dtype=dtype)
    _load(mod, {f"{fc}.{leaf}": fn(params[fc][jl]) for fc in ("fc1", "fc2")
                for jl, (leaf, fn) in {"kernel": ("weight", _dense_to_linear),
                                       "bias": ("bias", torch.from_numpy)}.items()})
    want = jmod.apply({"params": params}, jnp.asarray(x, JAX_DTYPES[dtype]))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(dtype))
    _compare(got, want, dtype)
    assert not np.allclose(got.float().numpy(), x, atol=1e-2)   # the gate is not 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_style_gate_matches_flax_with_jax_draws(dtype):
    c, b = 16, 3
    x = _x((b, 4, 6, c), 7)
    jmod = JaxStyleGate(c, alpha_min=0.4, alpha_max=0.9, dtype=JAX_DTYPES[dtype])
    rng = np.random.default_rng(8)
    params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": rng.uniform(-0.5, 0.5, c).astype(np.float32)}
    key = jax.random.PRNGKey(9)
    # the JAX gate's own draw
    alpha = jax.random.uniform(key, (b, 1, 1, 1), jnp.float32, minval=0.4, maxval=0.9)
    want = jmod.apply({"params": params}, jnp.asarray(x, JAX_DTYPES[dtype]), key)
    mod = StyleGate(c)
    _load(mod, params)
    xt = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        got = mod(xt, torch.from_numpy(np.array(alpha).reshape(b)))
        assert torch.equal(mod(xt), xt)   # no draw: the input itself
    _compare(got, want, dtype)


@pytest.mark.parametrize("flash", ["false", "off", "Auto", "true"])
def test_attn_flash_is_validated_as_in_jax(flash):
    with pytest.raises(ValueError, match="attn_flash"):
        SelfAttention2d(32, flash=flash)
    with pytest.raises(ValueError, match="attn_flash"):
        build_generator({"ngf": 8, "n_blocks": 2, "use_attention": True,
                         "attn_layers": [0], "attn_flash": flash}, FP32_POLICY)


@pytest.mark.parametrize("flash", [True, False, "auto"])
def test_attn_flash_selects_nothing(flash):
    x = torch.from_numpy(_x((1, 4, 4, 16), 10))
    mod = SelfAttention2d(16, flash=flash, generator=torch.Generator().manual_seed(0))
    ref = SelfAttention2d(16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mod.gamma.fill_(0.5)
        ref.gamma.fill_(0.5)
        torch.testing.assert_close(mod(x), ref(x), rtol=0, atol=0)
