"""The port's kernels on the card against their plain versions.

Needs a CUDA card of compute capability >= 9.0 and ``nvcc``; skips
otherwise.  Imports no jax, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as k2  # noqa: E402
from repro_torch.kernels import wkv6 as k3  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=40),
                                dict(causal=True, softcap=20.0)],
                         ids=["causal", "full", "window", "softcap"])
def test_flash_attention_matches_plain(card, kw, dh, dtype):
    g = torch.Generator(device=card).manual_seed(dh)
    B, S, H, K = 2, 150, 6, 2
    q, k, v = (torch.randn((B, S, n, dh), generator=g, device=card).to(dtype)
               for n in (H, K, K))
    before = fa.flash_attention.launches
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ops.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_wrapper_rejects_noncontiguous(card):
    q = torch.zeros(1, 16, 4, 32, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=40)],
                         ids=["causal", "window"])
def test_flash_attention_dh256_gqa16_matches_plain(card, kw, dtype):
    """recurrentgemma's local-attention heads: dh 256, 16 query heads on one
    KV head, a window, a ragged length."""
    g = torch.Generator(device=card).manual_seed(256)
    B, S = 2, 150
    q = torch.randn((B, S, 16, 256), generator=g, device=card).to(dtype)
    k, v = (torch.randn((B, S, 1, 256), generator=g, device=card).to(dtype) for _ in range(2))
    before = fa.flash_attention.launches
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ops.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _check_wgmma(card, B, Sq, H, K, dh, seed, **kw):
    """One bf16 call of K1 on the wgmma kernel against the plain version."""
    assert fa.variant(torch.bfloat16, dh) == "wgmma"
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, Sq, H, dh), generator=g, device=card).bfloat16()
    k, v = (torch.randn((B, Sq, K, dh), generator=g, device=card).bfloat16() for _ in range(2))
    before = dict(fa.flash_attention.launches_by_variant)
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_variant == dict(before, wgmma=before["wgmma"] + 1)
    want = ops.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])


WGMMA_SETTINGS = [dict(causal=True), dict(causal=False), dict(causal=True, window=40),
                  dict(causal=True, softcap=20.0)]
WGMMA_IDS = ["causal", "full", "window", "softcap"]


@pytest.mark.parametrize("S", [37, 150, 1000])   # ragged, none a multiple of the 128-row q tile
@pytest.mark.parametrize("kw", WGMMA_SETTINGS, ids=WGMMA_IDS)
@pytest.mark.parametrize("dh", [128, 256])
def test_wgmma_flash_attention_matches_plain(card, dh, kw, S):
    _check_wgmma(card, 2, S, 6, 2, dh, seed=S + dh, **kw)


@pytest.mark.parametrize("G", [1, 7, 16])
@pytest.mark.parametrize("dh", [128, 256])
def test_wgmma_flash_attention_gqa_matches_plain(card, dh, G):
    _check_wgmma(card, 2, 300, 2 * G, 2, dh, seed=G, causal=True)


@pytest.mark.parametrize("dh", [128, 256])
def test_wgmma_flash_attention_many_waves(card, dh):
    """B*H*q tiles = 4*56*4 = 896 CTAs of one SM each: several waves."""
    _check_wgmma(card, 4, 500, 56, 8, dh, seed=5, causal=True)


@pytest.mark.parametrize("dh", [128, 256])
def test_wgmma_single_kv_tile_no_mask(card, dh):
    """64 keys, no mask: one K/V tile at either head size and no masked
    element, so only the swizzle and the wgmma descriptors are tested."""
    _check_wgmma(card, 1, 64, 2, 1, dh, seed=11, causal=False)


@pytest.mark.parametrize("dh,S", [(128, 128), (256, 64)])
def test_wgmma_causal_one_q_tile(card, dh, S):
    """S = one q tile (two warpgroups of 64 rows at dh 128, one at dh 256):
    the causal mask alone tests which row and column each accumulator
    fragment holds."""
    _check_wgmma(card, 1, S, 2, 1, dh, seed=12, causal=True)


def _wkv_inputs(card, B, T, H, dh, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    r, k, v = (0.5 * torch.randn((B, T, H, dh), generator=g, device=card) for _ in range(3))
    logw = -torch.exp(torch.clamp(0.5 * torch.randn((B, T, H, dh), generator=g, device=card),
                                  -3, 0.5))
    u = 0.3 * torch.randn((H, dh), generator=g, device=card)
    s0 = torch.randn((B, H, dh, dh), generator=g, device=card)
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,dh,with_s0", [(2, 64, 3, 64, False), (1, 37, 2, 32, True),
                                              (3, 1, 4, 64, True), (2, 100, 2, 64, True)])
def test_wkv6_matches_plain(card, B, T, H, dh, with_s0, dtype):
    r, k, v, logw, u, s0 = _wkv_inputs(card, B, T, H, dh, dtype, seed=T)
    s0 = s0 if with_s0 else None
    before = k3.wkv6_kernel.launches
    y, s = ops.wkv6(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert k3.wkv6_kernel.launches == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    y_want, s_want = ops.wkv6_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y.float(), y_want.float(), **TOL[dtype])
    torch.testing.assert_close(s, s_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("T", [1, 7, 8, 9, 15, 16, 17, 100])
def test_wkv6_value_split_and_staging_edges(card, T, dh, with_s0, dtype):
    """K3 split into dh / 16 column blocks per (b, h) (2 at dh 32, 4 at
    dh 64), with B*H = 21 (B = 3, H = 7), at lengths around its staged
    blocks of 8 steps and its ring of raw stages (T = 100: 13 blocks)."""
    B, H = 3, 7
    r, k, v, logw, u, s0 = _wkv_inputs(card, B, T, H, dh, dtype, seed=1000 + T)
    s0 = s0 if with_s0 else None
    before = k3.wkv6_kernel.launches
    y, s = ops.wkv6(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert k3.wkv6_kernel.launches == before + 1
    y_want, s_want = ops.wkv6_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y.float(), y_want.float(), **TOL[dtype])
    torch.testing.assert_close(s, s_want, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("T", [16, 37])
def test_wkv6_prefill_then_steps_equals_one_call(card, T, dh, dtype):
    """The decode path: a prefill of T steps, then 8 single-step calls
    threaded through s_final, gives the y and the state of one call over
    T + 8 steps."""
    B, H, steps = 2, 5, 8
    r, k, v, logw, u, _ = _wkv_inputs(card, B, T + steps, H, dh, dtype, seed=2000 + T)
    y_all, s_all = k3.wkv6_kernel(r, k, v, logw, u)
    ys = []
    y, s = k3.wkv6_kernel(*(a[:, :T].contiguous() for a in (r, k, v, logw)), u)
    ys.append(y)
    for t in range(T, T + steps):
        y, s = k3.wkv6_kernel(*(a[:, t:t + 1].contiguous() for a in (r, k, v, logw)), u, s)
        ys.append(y)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(ys, dim=1).float(), y_all.float(), **TOL[dtype])
    torch.testing.assert_close(s, s_all, **TOL[torch.float32])


def test_wkv6_schedule_keeps_the_serving_grid_resident(card):
    """At rwkv6-3b's prefill (B=4, H=40, dh=64, bf16) every CTA of the grid
    is resident at once: one wave, no second round on a few SMs."""
    sched = k3.schedule(torch.bfloat16, 64)
    assert sched["value_columns"] == k3.VALUE_COLUMNS_PER_CTA
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert sched["ctas_per_sm"] * sms >= k3.grid(4, 40, 64)


def test_wkv6_rejects_misaligned_inputs(card):
    buf = torch.zeros(1 * 4 * 2 * 64 + 1, device=card)
    r = buf[1:].view(1, 4, 2, 64)      # contiguous, 4 bytes past a boundary
    ok = torch.zeros(1, 4, 2, 64, device=card)
    with pytest.raises(ValueError, match="16-byte boundary"):
        k3.wkv6_kernel(r, ok, ok, ok, torch.zeros(2, 64, device=card))


def _scan_inputs(card, B, S, W, seed, with_h0):
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.rand((B, S, W), generator=g, device=card) * 0.79 + 0.2
    b = torch.randn((B, S, W), generator=g, device=card)
    h0 = torch.randn((B, W), generator=g, device=card) if with_h0 else None
    return a, b, h0


def _check_scan(card, B, S, W, with_h0, seed):
    """One call of K2 through ``ops.rglru_scan``: counted once, on the kernel
    ``variant`` names, and equal to the plain loop bit for bit (both round
    after the product and after the sum)."""
    a, b, h0 = _scan_inputs(card, B, S, W, seed, with_h0)
    kind = k2.variant(B, S, W)
    before = dict(k2.rglru_scan_kernel.launches_by_variant)
    total = k2.rglru_scan_kernel.launches
    got = ops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert k2.rglru_scan_kernel.launches == total + 1
    assert k2.rglru_scan_kernel.launches_by_variant == dict(before, **{kind: before[kind] + 1})
    assert torch.equal(got, ops.rglru_scan_ref(a, b, h0))
    return kind


@pytest.mark.parametrize("B,S,W,with_h0", [(2, 64, 128, False), (3, 37, 100, True),
                                           (2, 1, 4096, True), (1, 300, 64, True)])
def test_rglru_scan_matches_plain(card, B, S, W, with_h0):
    _check_scan(card, B, S, W, with_h0, seed=S)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("W", [4, 100, 4100])   # none a multiple of the 64-channel tile
@pytest.mark.parametrize("S", [2, 37, 64, 300, 4097])   # ragged around the 32-step blocks
def test_rglru_scan_staged_is_bit_exact(card, S, W, with_h0, B):
    """The staged kernel at ragged lengths and widths: the tensor maps' zero
    fill past S and W, the 3-stage ring wrapping (S = 4097: 129 blocks), and
    h0 present and absent."""
    assert _check_scan(card, B, S, W, with_h0, seed=S + W + B) == "staged"


def test_rglru_scan_serving_prefill_is_bit_exact(card):
    """recurrentgemma-9b's prefill shape (B=2, S=4096, W=4096) on the
    staged kernel."""
    assert _check_scan(card, 2, 4096, 4096, False, seed=4096) == "staged"


@pytest.mark.parametrize("B,W", [(2, 4096), (3, 100), (1, 99)])
def test_rglru_scan_decode_step_takes_the_simple_kernel(card, B, W):
    """S = 1 from h0 (the decode step) goes to the simple kernel."""
    assert _check_scan(card, B, 1, W, True, seed=W) == "simple"


@pytest.mark.parametrize("S", [37, 300])
def test_rglru_scan_odd_width_takes_the_simple_kernel(card, S):
    """W % 4 != 0 has no tensor map; the simple kernel takes it."""
    assert _check_scan(card, 2, S, 99, True, seed=S) == "simple"


@pytest.mark.parametrize("kind", ["staged", "simple"])
@pytest.mark.parametrize("B,S,W", [(2, 300, 100), (1, 4097, 4100)])
def test_rglru_scan_both_kernels_are_bit_exact(card, kind, B, S, W):
    """Each kernel, launched uncounted at the shapes ``variant`` gives the
    other or both, equals the plain loop bit for bit."""
    a, b, h0 = _scan_inputs(card, B, S, W, seed=S, with_h0=True)
    total = k2.rglru_scan_kernel.launches
    got = k2.launch(kind, a, b, h0)
    torch.cuda.synchronize()
    assert k2.rglru_scan_kernel.launches == total
    assert torch.equal(got, ops.rglru_scan_ref(a, b, h0))


def test_rglru_scan_prefill_then_steps_equals_one_call(card):
    """The serving path: a staged prefill of S steps, then 8 simple steps
    threaded through h[:, -1], give the h of one call over S + 8 steps."""
    B, S, W, steps = 2, 300, 4096, 8
    a, b, _ = _scan_inputs(card, B, S + steps, W, seed=7, with_h0=False)
    h_all = k2.rglru_scan_kernel(a, b)
    hs = [k2.rglru_scan_kernel(a[:, :S].contiguous(), b[:, :S].contiguous())]
    for t in range(S, S + steps):
        hs.append(k2.rglru_scan_kernel(a[:, t:t + 1].contiguous(), b[:, t:t + 1].contiguous(),
                                       hs[-1][:, -1].contiguous()))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(hs, dim=1), h_all)


def test_rglru_schedule_keeps_the_serving_grid_resident(card):
    """At recurrentgemma-9b's prefill (B=2, W=4096) every CTA of the staged
    grid is resident at once: one wave."""
    sched = k2.schedule()
    assert sched["channels"] == k2.CHANNELS_PER_CTA
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert sched["ctas_per_sm"] * sms >= k2.grid(2, 4096)


def test_rglru_scan_rejects_misaligned_inputs(card):
    buf = torch.zeros(1 * 4 * 8 + 1, device=card)
    a = buf[1:].view(1, 4, 8)          # contiguous, 4 bytes past a boundary
    ok = torch.zeros(1, 4, 8, device=card)
    assert k2.variant(1, 4, 8) == "staged"
    with pytest.raises(ValueError, match="16-byte boundary"):
        k2.rglru_scan_kernel(a, ok)


def test_recurrence_wrappers_reject_bad_inputs(card):
    a = torch.zeros(1, 4, 8, device=card)
    with pytest.raises(TypeError, match="float32"):
        k2.rglru_scan_kernel(a.bfloat16(), a.bfloat16())
    r = torch.zeros(1, 4, 2, 48, device=card)
    with pytest.raises(ValueError, match="head dim"):
        k3.wkv6_kernel(r, r, r, r, torch.zeros(2, 48, device=card))


@pytest.mark.parametrize("arch", ["yi-34b", "rwkv6-3b", "recurrentgemma-9b"])
def test_train_step_on_card_launches_no_kernel(card, arch):
    """One reduced train step on the card, against the same step on the CPU
    from the same weights (fp32 compute, TF32 off): training runs the plain
    forms, so no kernel counter moves (the kernels have no backward)."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    metrics = {}
    counters = (fa.flash_attention, k2.rglru_scan_kernel, k3.wkv6_kernel)
    before = [fn.launches for fn in counters]
    for dev in ("cpu", card):
        state = steps.init_state(cfg, opt, seed=0)
        state["params"].to(dev)
        state["opt"] = adamw.init(dict(state["params"].named_parameters()), opt)
        _, m = steps.make_train_step(cfg, opt)(
            state, {k: v.to(dev) for k, v in batch.items()})
        metrics[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
    assert [fn.launches for fn in counters] == before
    (l0, n0), (l1, n1) = metrics.values()
    assert l1 == pytest.approx(l0, rel=1e-4) and n1 == pytest.approx(n0, rel=1e-4)
