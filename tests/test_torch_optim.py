"""The port's hand-written AdamW against the reference's on the CPU.

Five ``update`` steps from the same parameters and the same seeded
gradients (large enough that clipping acts, past the warmup into the
cosine decay) must give the same parameters, moments, step, grad_norm and
lr to 1e-6; with bfloat16 parameters the fp32 master copy is kept and the
bfloat16 parameters agree within one bfloat16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

SHAPES = {"embed.table": (16, 8), "layers.0.attn.wq.w": (8, 12),
          "layers.0.ln1.scale": (8,), "logits.w": (8, 16)}
KW = dict(lr=1e-2, warmup_steps=2, decay_steps=6, clip_norm=2.0)
STEPS = 5
TOL = dict(rtol=1e-6, atol=1e-7)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    # the first steps' gradients are large (clipped), the later ones small
    grads = [{n: (rng.standard_normal(s) * (3.0 if t < 2 else 0.05)).astype(np.float32)
              for n, s in SHAPES.items()} for t in range(STEPS)]
    return params, grads


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _run_both(dtype, seed=0):
    cfg_j, cfg_t = jadamw.AdamWConfig(**KW), adamw.AdamWConfig(**KW)
    params, grads = _inputs(seed)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jp = {n: jnp.asarray(a).astype(jdt) for n, a in params.items()}
    tp = {n: torch.tensor(a).to(tdt) for n, a in params.items()}
    js, ts = jadamw.init(jp, cfg_j), adamw.init(tp, cfg_t)
    out = []
    for g in grads:
        jp, js, jm = jadamw.update({n: jnp.asarray(a).astype(jdt) for n, a in g.items()},
                                   js, jp, cfg_j)
        tp, ts, tm = adamw.update({n: torch.tensor(a).to(tdt) for n, a in g.items()},
                                  ts, tp, cfg_t)
        # the port updates in place: keep a copy of this step's state
        out.append(((jp, js, jm), _copy((tp, ts, tm))))
    return out


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_copy(v) for v in tree)
    return tree.clone()


def test_five_steps_match_reference():
    for t, ((jp, js, jm), (tp, ts, tm)) in enumerate(_run_both("float32")):
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), **TOL,
                                       err_msg=f"step {t + 1} {key}")
        assert int(ts["step"]) == int(js["step"]) == t + 1
        for n in SHAPES:
            for what, a, b in (("param", tp[n], jp[n]), ("m", ts["m"][n], js["m"][n]),
                               ("v", ts["v"][n], js["v"][n])):
                np.testing.assert_allclose(_np(a), _np(b), **TOL,
                                           err_msg=f"step {t + 1} {what} {n}")
    # the run clips, warms up and decays: the test sees every branch
    norms = [float(_np(tm["grad_norm"])) for _, (_, _, tm) in _run_both("float32")]
    lrs = [float(_np(tm["lr"])) for _, (_, _, tm) in _run_both("float32")]
    assert norms[0] > KW["clip_norm"] > norms[-1]
    assert lrs[1] == pytest.approx(KW["lr"]) and lrs[-1] < lrs[1]


def test_no_master_for_fp32_parameters():
    state = adamw.init({"w": torch.zeros(3)}, adamw.AdamWConfig())
    assert "master" not in state and state["step"].dtype == torch.int32


def test_bf16_parameters_keep_fp32_master():
    runs = _run_both("bfloat16", seed=1)
    (_, js, _), (tp, ts, _) = runs[0]
    assert set(ts) == set(js) == {"m", "v", "step", "master"}
    for (jp, js, jm), (tp, ts, tm) in runs:
        for n in SHAPES:
            assert tp[n].dtype == torch.bfloat16
            assert ts["master"][n].dtype == torch.float32
            np.testing.assert_allclose(_np(ts["master"][n]), _np(js["master"][n]), **TOL)
            a, b = _np(tp[n]), _np(jp[n])
            # one bfloat16 ulp at each value's magnitude (8 significant bits)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
            assert np.all(np.abs(a - b) <= ulp), n
