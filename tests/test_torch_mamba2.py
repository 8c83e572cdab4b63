"""The port's hybrid Mamba-2 stack (Nemotron-H) on the CPU against the plain
sequential reference ``tests/_nemotron_h_ref.py``, and K4, the decode
step's state update (``csrc/ssm_state_update.cu``), whose card test skips
here.

The program's prefill runs the chunked SSD scan, its decode step the
state update; the reference runs the recurrence token by token.  In fp32
the two agree to 1e-4 (sums taken in another order, nothing else).
Imports no jax.
"""
import math
import re

import pytest

torch = pytest.importorskip("torch")

import _nemotron_h_ref as ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ssm_state_update as k4  # noqa: E402
from repro_torch.models import Model, init_params  # noqa: E402
from repro_torch.models.mamba2 import HybridConfig, ssd_chunked  # noqa: E402
from repro_torch.models.layers import apply_logits  # noqa: E402
from repro_torch.models.model import forward, sinusoidal_positions  # noqa: E402
from repro_torch.models.transformer import Kernels, layer_cache_shape  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
PATTERN = ("mamba2", "mlp", "attn", "mamba2", "mlp")


def tiny(**kw) -> HybridConfig:
    """Every layer kind at tiny widths, fp32, heads in two groups, chunks
    of 8 (prompts of 21 end in a ragged chunk)."""
    base = dict(name="tiny-hybrid", family="hybrid", n_layers=len(PATTERN), d_model=64,
                n_heads=4, n_kv_heads=2, d_head=16, d_ff=96, vocab_size=128,
                block_pattern=PATTERN, use_rope=False, mlp_act="sq_relu",
                param_dtype="float32", compute_dtype="float32", ssm_heads=4,
                ssm_head_dim=16, ssm_groups=2, ssm_state=16, ssm_chunk=8)
    return HybridConfig(**{**base, **kw})


def model_of(cfg: HybridConfig, seed: int = 0) -> Model:
    """Seeded weights with every norm scale, conv bias and dt bias drawn
    too (init_params leaves them zero), so each term is exercised."""
    model = init_params(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("scale", "conv_b", "dt_bias")):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return model


def tokens(cfg: HybridConfig, B: int, S: int, seed: int = 0) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(seed))


def serve(model: Model, toks: torch.Tensor, S: int, kernels=None):
    """Logits of prefill's last position and of each later token through
    the cache: (B, T + 1, V) for T = toks' length past S."""
    kw = {} if kernels is None else dict(kernels=kernels)
    lg, cache = model.prefill(toks[:, :S], toks.shape[1], **kw)
    rows = [lg[:, 0]]
    for i in range(S, toks.shape[1]):
        lg, cache = model.decode_step(toks[:, i:i + 1], i, cache, **kw)
        rows.append(lg[:, 0])
    return torch.stack(rows, dim=1), cache


@pytest.mark.parametrize("S, chunk", [(1, 8), (21, 8), (37, 16), (64, 16)])
def test_ssd_chunked_matches_the_sequential_recurrence(S, chunk):
    """Chunked SSD (intra-chunk products under the decay mask, states
    passed between chunks) against the token-by-token recurrence, output
    and final state, with chunks ragged or whole, and decays from near 0
    to near 1."""
    g = torch.Generator().manual_seed(S)
    b, H, P, G, N = 2, 6, 8, 3, 16
    x = torch.randn(b, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, S, H, generator=g))
    A = -torch.exp(2.0 * torch.randn(H, generator=g))
    B, C = (torch.randn(b, S, G, N, generator=g) for _ in range(2))
    y, state = ssd_chunked(x, dt, A, B, C, chunk)
    y_ref, state_ref = ref.ssm_scan(x, dt, A, B, C, torch.zeros(H))
    torch.testing.assert_close(y, y_ref, **TOL)
    torch.testing.assert_close(state, state_ref, **TOL)


def test_prefill_then_decode_matches_the_full_forward():
    """Prefill of 21 tokens, then 6 decode steps through the cache, against
    the reference's forward over all 27, in fp32."""
    cfg = tiny()
    model = model_of(cfg)
    toks = tokens(cfg, 2, 27)
    got, _ = serve(model, toks, 21)
    want = ref.forward(cfg, dict(model.named_parameters()), toks)[:, 20:]
    torch.testing.assert_close(got, want, **TOL)


def k4_inputs(batch, H, P, G, N, dtype=torch.float32, device="cpu", seed=0):
    """K4's arguments as the decode step passes them: z, xbc and dt column
    slices of one in-projection row, decays spread from ~0 to ~1."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (std * torch.randn(shape, generator=g, device=device)).to(dtype)

    conv = H * P + 2 * G * N
    row = rnd(batch, H * P + conv + H)
    z, xbc, dt = row.split([H * P, conv, H], dim=-1)
    state = torch.randn((batch, H, P, N), generator=g, device=device)
    return dict(state=state, conv_state=rnd(batch, conv, 3), z=z, xbc=xbc, dt=dt,
                conv_w=rnd(conv, 4, std=0.5), conv_b=rnd(conv, std=0.1),
                dt_bias=rnd(H), A_log=rnd(H, std=2.0), D=rnd(H), norm_scale=rnd(H * P, std=0.1))


def test_k4_plain_form_follows_the_equations():
    """``ops.ssm_state_update`` on the CPU against the equations written out
    element by element: the conv over the conv state's inputs and the new
    one, the conv state rolled; head h reads group h // (H / G); the state
    updated in place, y read from the new state; the gated norm over G
    groups."""
    batch, H, P, G, N = 2, 4, 3, 2, 5
    a = k4_inputs(batch, H, P, G, N, seed=3)
    s0, c0 = a["state"].clone(), a["conv_state"].clone()
    conv = H * P + 2 * G * N
    u = torch.empty(batch, conv)
    for b in range(batch):
        for c in range(conv):
            taps = [*c0[b, c], a["xbc"][b, c]]
            v = a["conv_b"][c] + sum(a["conv_w"][c, j] * taps[j] for j in range(4))
            u[b, c] = v / (1 + math.exp(-v))
    want_s, y = s0.clone(), torch.empty(batch, H * P)
    for b in range(batch):
        for h in range(H):
            grp = h // (H // G)
            dt = math.log1p(math.exp(a["dt"][b, h] + a["dt_bias"][h]))
            decay = math.exp(-dt * math.exp(a["A_log"][h]))
            for p in range(P):
                x = u[b, h * P + p]
                for n in range(N):
                    want_s[b, h, p, n] = decay * s0[b, h, p, n] \
                        + dt * x * u[b, H * P + grp * N + n]
                y[b, h * P + p] = sum(want_s[b, h, p, n] * u[b, H * P + (G + grp) * N + n]
                                      for n in range(N)) + a["D"][h] * x
    hz = y * a["z"] / (1 + torch.exp(-a["z"]))
    size = H * P // G
    want = torch.empty(batch, H * P)
    for b in range(batch):
        for grp in range(G):
            part = hz[b, grp * size:(grp + 1) * size]
            want[b, grp * size:(grp + 1) * size] = part / torch.sqrt((part ** 2).mean() + 1e-6)
    want = want * (1 + a["norm_scale"])
    got = ops.ssm_state_update(**a)
    torch.testing.assert_close(a["state"], want_s, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a["conv_state"], torch.cat([c0[..., 1:], a["xbc"][..., None]], -1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_stale_ssm_state_changes_the_logits():
    """A decode step that reads its Mamba-2 state zeroed, or not updated by
    the step before, gives other logits: the state carries the prompt."""
    cfg = tiny()
    model = model_of(cfg)
    toks = tokens(cfg, 2, 23)
    lg, cache = model.prefill(toks[:, :21], 23)
    stale = [{k: v.clone() for k, v in c.items()} for c in cache]
    for c in stale:
        if "ssm" in c:
            c["ssm"].zero_()
    good, cache = model.decode_step(toks[:, 21:22], 21, cache)
    bad, _ = model.decode_step(toks[:, 21:22], 21, stale)
    assert (good - bad).abs().max() > 1e-2
    before = [c["ssm"].clone() for c in cache if "ssm" in c]
    model.decode_step(toks[:, 22:23], 22, cache)
    after = [c["ssm"] for c in cache if "ssm" in c]
    assert all(not torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("kind, want", [
    ("mamba2", {"conv": ((3, 64 + 2 * 2 * 16, 3), torch.bfloat16),
                "ssm": ((3, 4, 16, 16), torch.float32)}),
    ("attn", {"k": ((3, 40, 2, 16), torch.bfloat16), "v": ((3, 40, 2, 16), torch.bfloat16)}),
    ("mlp", {}),
])
def test_layer_cache_shape(kind, want):
    """Two kinds of state in one cache: K/V buffers of s_buf positions in an
    attention layer; the conv's last taps - 1 inputs (compute dtype) and
    the fp32 SSM state in a Mamba-2 layer; nothing in an MLP layer."""
    cfg = tiny(compute_dtype="bfloat16")
    assert layer_cache_shape(cfg, kind, 3, 40) == want


def test_port_only_config_beside_the_registry():
    """``get_config`` finds nemotron-h-47b through ``PORT_ONLY`` at its
    published widths and pattern; the registry keeps the JAX package's ten
    architectures and cells."""
    cfg = configs.get_config("nemotron-h-47b")
    assert isinstance(cfg, HybridConfig)
    kinds = cfg.layer_kinds
    assert (len(kinds), kinds.count("mamba2"), kinds.count("mlp"), kinds.count("attn")) == \
        (98, 45, 48, 5)
    assert cfg.ssm_sizes == (256, 64, 8, 256, 16384, 20480)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab_size) == \
        (8192, 64, 8, 128, 30720, 131072)
    assert not cfg.use_rope and not sinusoidal_positions(cfg) and cfg.mlp_act == "sq_relu"
    assert "nemotron-h-47b" not in configs.list_archs()
    assert len(configs.list_archs()) == 10 == len(configs.ARCH_MODULES)
    assert {arch for arch, _, _ in configs.all_cells()} == set(configs.ARCH_MODULES)
    with pytest.raises(KeyError, match="unknown architecture"):
        configs.get_config("nemotron-h-99b")


def test_params_are_counted_by_kind():
    """``active_params`` and ``total_params`` count every parameter of the
    three kinds, as a hand count and as the model holds them."""
    cfg = tiny()
    d, f, V, H, P, G, N = 64, 96, 128, 4, 16, 2, 16
    di, conv = H * P, H * P + 2 * G * N
    mamba = d * (di + conv + H) + (4 + 1) * conv + 3 * H + di + di * d
    attn = 2 * d * 4 * 16 + 2 * d * 2 * 16
    mlp = 2 * d * f
    hand = 2 * V * d + d + 2 * (mamba + d) + (attn + d) + 2 * (mlp + d)
    assert cfg.active_params() == cfg.total_params() == hand
    assert hand == sum(p.numel() for p in Model(cfg, "meta").parameters())


def test_serving_path_feeds_k4_what_it_takes():
    """The decode step hands K4 the in-projection's row as it lies (z, xbc,
    dt column slices with their row strides), the cache's two states and
    the layer's weights: every call passes the wrapper's own checks, one per
    Mamba-2 layer per decode step, at the state size the kernel takes (N =
    256), in bf16 as served."""
    cfg = tiny(compute_dtype="bfloat16", param_dtype="bfloat16", ssm_state=256)
    calls = []

    def update(*args):
        k4.check_inputs(*args)
        calls.append(args[0].shape)
        return ops.ssm_state_update(*args)

    bundle = Kernels(ops.attention, ops.wkv6, ops.rglru_scan, update)
    model = init_params(cfg, 0, "cpu")
    _, cache = serve(model, tokens(cfg, 3, 12), 9, kernels=bundle)
    assert calls == [(3, 4, 16, 256)] * (2 * 3)
    assert all(c["ssm"].dtype == torch.float32 for c in cache if "ssm" in c)


def test_a_hybrid_stack_adds_no_positions():
    """No position embedding: the attention layers take no rope and the
    embedding no sinusoids, so an attention-only stack is blind to order."""
    cfg = tiny(n_layers=1, block_pattern=("attn",))
    model = model_of(cfg)
    toks = tokens(cfg, 1, 6)
    swapped = toks[:, [1, 0, 2, 3, 4, 5]]
    a, _ = model.prefill(toks, 6)
    b, _ = model.prefill(swapped, 6)
    torch.testing.assert_close(a, b, **TOL)
    assert not sinusoidal_positions(cfg)
    assert sinusoidal_positions(configs.get_config("rwkv6-3b"))


def test_k4_wrapper_constants_match_the_source():
    """The rows a state-update CTA takes, the conv's taps and the state
    size, as the wrapper checks them, are the kernel's
    (``csrc/ssm_state_update.cu``)."""
    src = (_build.CSRC / "ssm_state_update.cu").read_text()
    assert int(re.search(r"constexpr int ROWS = (\d+);", src).group(1)) == k4.ROWS_PER_CTA
    assert int(re.search(r"constexpr int TAPS = (\d+);", src).group(1)) == k4.TAPS
    assert int(re.search(r"constexpr int STATE = (\d+);", src).group(1)) == k4.STATE


def test_forward_without_a_cache_matches_the_reference():
    """``models.model.forward`` (no cache, the plain forms: the training
    path) over the three kinds against the reference's forward, fp32."""
    cfg = tiny()
    model = model_of(cfg)
    toks = tokens(cfg, 2, 19)
    got = apply_logits(model.logits, model.embed, forward(model, toks, remat=False), cfg)
    want = ref.forward(cfg, dict(model.named_parameters()), toks)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("change, match", [
    (dict(N=128), "state size"), (dict(P=8), "unsupported sizes"),
    (dict(state=torch.bfloat16), "float32"), (dict(conv_b=torch.float16), "conv_b"),
    (dict(z=torch.float32), "z has dtype"), (dict(taps=5), "conv_w has shape"),
])
def test_k4_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    a = k4_inputs(2, 4, change.get("P", 16), 2, change.get("N", 256), dtype=torch.bfloat16)
    if "state" in change:
        a["state"] = a["state"].to(change["state"])
    for name in ("conv_b", "z"):
        if name in change:
            a[name] = a[name].to(change[name])
    if "taps" in change:
        a["conv_w"] = torch.zeros(a["conv_w"].shape[0], change["taps"], dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError), match=match):
        k4.check_inputs(*a.values())


@pytest.mark.cuda
@pytest.mark.parametrize("batch, dtype", [(32, torch.bfloat16), (3, torch.float32)])
def test_k4_on_the_card_matches_its_plain_form(batch, dtype):
    """K4 against ``ops.ssm_state_update_ref`` at Nemotron-H's decode shape
    (H 256, P 64, G 8, N 256, batch 32, bf16 as served) and a small fp32
    one: the output, both states.  The state update is one fused
    multiply-add a state element where the plain form rounds twice, and
    the norm sums in another order: fp32 to 1e-4, bf16 outputs to a bf16
    ulp."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    a = k4_inputs(batch, 256, 64, 8, 256, dtype=dtype, device="cuda", seed=batch)
    b = {k: v.clone() for k, v in a.items()}
    before = k4.ssm_state_update_kernel.launches
    got = ops.ssm_state_update(**a)
    torch.cuda.synchronize()
    assert k4.ssm_state_update_kernel.launches == before + 1
    want = ops.ssm_state_update_ref(**b)
    torch.testing.assert_close(a["state"], b["state"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a["conv_state"], b["conv_state"], rtol=0, atol=0)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
