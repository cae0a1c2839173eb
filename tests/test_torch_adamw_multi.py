"""The multi-tensor AdamW update (`cuda_kernels.adamw_multi`) on the CPU.

On CPU tensors the wrapper runs the plain rule tensor by tensor, so the
route's contract is held here: bit-equal to `adamw_plain_scalars` per
tensor over 5 steps on mixed lists (float32, bfloat16 and float16
parameters with float32 and bfloat16 gradients; coeff 0 and 0.01; scaled
and not; a per-tensor lr factor, whose buffer is the optimizer's float32
product; the guard word at 0), every bad input refused with ValueError
before anything is updated or launched, and the optimizer's call pattern
(one gate call a (parameter dtype, gradient dtype) group a step, the plain
rule tensor by tensor with use_fused_optimizer off). The kernel's own
arithmetic is held on the card (chip_smoke.py `check_adamw_multi`); its
work split is mirrored here: the packed table's chunk prefixes, read by a
numpy copy of the kernel's binary search, cover every element of every
tensor once, and a group past the table's capacity splits into
consecutive launches. `Adam` and `AdamW` (decay exemption by name, the
global-norm clip with a need_clip False parameter, per-parameter lr
factors, all together) hold the JAX package's rule over 3 steps at
float32 (rtol 1e-6 / atol 1e-7, tests/test_torch_optimizers.py's
tolerance: XLA may contract a multiply-add into an FMA).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.framework.tensor import Parameter as JParam
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401  (one intra-op thread a worker)

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

KW = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)
TYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
SIZES = (1, 3, 7, 128, 255, 4097)
LR_FACTORS = (1.0, 0.5, 2.0 / 3.0)


def _entries(pdt, gdt, variant, seed=0):
    """Six (param, grad, m1, m2) lists of the given types, and their
    per-tensor coeff, scaled and lr factor for `variant`."""
    rs = np.random.RandomState(seed)
    n = len(SIZES)
    mixed_types = [(TYPES[("f32", "bf16", "f16")[i % 3]],
                    TYPES[("f32", "bf16")[i % 2]]) for i in range(n)]
    types = mixed_types if variant == "mixed" else [(pdt, gdt)] * n
    ps, gs, m1, m2 = [], [], [], []
    for size, (p_t, g_t) in zip(SIZES, types):
        ps.append(torch.from_numpy(rs.randn(size).astype(np.float32)
                                   * 1e-2).to(p_t))
        gs.append(torch.from_numpy(rs.randn(size).astype(np.float32)
                                   * 1e-2).to(g_t))
        m1.append(torch.from_numpy(rs.randn(size).astype(np.float32) * 1e-3))
        m2.append(torch.from_numpy(rs.rand(size).astype(np.float32) * 1e-5))
    coeff = {"coeff0": 0.0, "coeff": 0.01}.get(
        variant, [(0.0, 0.01)[i % 2] for i in range(n)])
    scaled = {"scaled": True, "coeff0": False, "coeff": False}.get(
        variant, [i % 3 == 1 for i in range(n)])
    lrf = ([LR_FACTORS[i % 3] for i in range(n)]
           if variant in ("lr_factor", "mixed") else 1.0)
    return [ps, gs, m1, m2], dict(coeff=coeff, scaled=scaled, lr_factor=lrf)


def _per(value, i):
    return value[i] if isinstance(value, list) else value


def _plain(state, sc, attrs):
    """The plain rule tensor by tensor, each factor's buffer made as the
    optimizer makes it (`Optimizer._param_scalars`)."""
    for i, (p, g, a, b) in enumerate(zip(*state)):
        f = _per(attrs["lr_factor"], i)
        psc = sc if f == 1.0 else torch.cat((sc[:1] * float(f), sc[1:]))
        ck.adamw_plain_scalars(p, g, a, b, psc, coeff=_per(attrs["coeff"], i),
                               scaled=_per(attrs["scaled"], i), **KW)


def _stage(sc, t, go=1.0, scale=0.3711):
    vals = ck.adam_step_scalars(1e-2 if t <= 2 else 3e-3, t, 0.9, 0.999)
    vals[ck.GO], vals[ck.SCALE] = go, scale
    sc.copy_(torch.from_numpy(vals))


VARIANTS = ["coeff0", "coeff", "scaled", "lr_factor", "go0"]
CASES = ([(p, g, v) for p in ("f32", "bf16", "f16") for g in ("f32", "bf16")
          for v in VARIANTS] + [("f32", "f32", "mixed")])


@pytest.mark.parametrize("pdt,gdt,variant", CASES,
                         ids=["-".join(c) for c in CASES])
def test_cpu_route_equals_the_plain_rule_per_tensor(pdt, gdt, variant):
    """5 steps (lr 1e-2, then 3e-3 from t = 3; the clip scale 0.3711):
    parameters and both moments bit-equal to the plain rule per tensor
    after every step; at `go0` steps 2 and 4 write nothing."""
    state, attrs = _entries(TYPES[pdt], TYPES[gdt], variant)
    want = [[t.clone() for t in col] for col in state]
    sc = torch.empty(5)
    before = ck.launch_counts()
    for t in range(1, 6):
        go = 0.0 if variant == "go0" and t % 2 == 0 else 1.0
        _stage(sc, t, go)
        kept = [p.clone() for p in state[0]]
        ck.adamw_multi(*state, sc, **KW, **attrs)
        _plain(want, sc, attrs)
        for col, wcol in zip(state, want):
            for x, y in zip(col, wcol):
                assert x.dtype == y.dtype and torch.equal(x, y), (t, variant)
        if go == 0.0:
            assert all(torch.equal(a, b) for a, b in zip(kept, state[0]))
        else:
            assert any(not torch.equal(a, b) for a, b in zip(kept, state[0]))
    assert ck.launch_counts() == before             # CPU: the plain rule


def _bad_inputs():
    f = lambda n=8: torch.zeros(n)  # noqa: E731
    return {
        "empty": ([], [], [], []),
        "unequal lengths": ([f(), f()], [f()], [f(), f()], [f(), f()]),
        "float64 param": ([f(), f().double()], [f(), f()], [f(), f()],
                          [f(), f()]),
        "int32 grad": ([f()], [f().int()], [f()], [f()]),
        "bfloat16 moment": ([f()], [f()], [f().bfloat16()], [f()]),
        "strided grad": ([f()], [f(16)[::2]], [f()], [f()]),
        "shape mismatch": ([f()], [f(4)], [f()], [f()]),
        "two devices": ([f(), torch.zeros(8, device="meta")],
                        [f(), f()], [f(), f()], [f(), f()]),
        "empty tensor": ([f(), f(0)], [f(), f(0)], [f(), f(0)], [f(), f(0)]),
    }


@pytest.mark.parametrize("what", sorted(_bad_inputs()))
def test_bad_inputs_raise_before_anything_runs(what):
    """Each bad input raises ValueError; the good first entry of the list
    is not updated and no launch is counted."""
    lists = _bad_inputs()[what]
    sc = torch.from_numpy(ck.adam_step_scalars(1e-2, 1, 0.9, 0.999))
    for col in lists:
        for t in col:
            if t.dtype.is_floating_point and t.device.type == "cpu":
                t.add_(0.5)
    kept = [t.clone() for t in lists[0] if t.device.type == "cpu"]
    before = ck.launch_counts()
    with pytest.raises(ValueError):
        ck.adamw_multi(*lists, sc, coeff=0.01, **KW)
    with pytest.raises(ValueError):
        ck.fused_adamw_multi_or_none(lists[0], lists[1], sc, lists[2],
                                     lists[3], coeff=0.01, **KW)
    assert ck.launch_counts() == before
    assert all(torch.equal(a, b) for a, b in zip(
        kept, [t for t in lists[0] if t.device.type == "cpu"]))


@pytest.mark.parametrize("what", ["4-word buffer, scaled", "float64 buffer",
                                  "3 coeffs for 2", "1 lr factor for 2"])
def test_bad_scalars_and_attributes_raise(what):
    ps, gs, m1, m2 = ([torch.zeros(4), torch.zeros(4)] for _ in range(4))
    sc = torch.from_numpy(ck.adam_step_scalars(1e-2, 1, 0.9, 0.999))
    kw = dict(KW, coeff=0.0)
    if what == "4-word buffer, scaled":
        sc, kw["scaled"] = sc[:4].clone(), [False, True]
    elif what == "float64 buffer":
        sc = sc.double()
    elif what == "3 coeffs for 2":
        kw["coeff"] = [0.0, 0.01, 0.0]
    else:
        kw["lr_factor"] = [0.5]
    with pytest.raises(ValueError):
        ck.adamw_multi(ps, gs, m1, m2, sc, **kw)
    assert all(not t.any() for t in ps)


def test_flag_off_gate_returns_none_and_writes_nothing():
    ps, gs, m1, m2 = ([torch.ones(4)] for _ in range(4))
    sc = torch.from_numpy(ck.adam_step_scalars(1e-2, 1, 0.9, 0.999))
    flags.set_flags({"use_fused_optimizer": False})
    try:
        assert ck.fused_adamw_multi_or_none(ps, gs, sc, m1, m2, coeff=0.01,
                                            **KW) is None
    finally:
        flags.set_flags({"use_fused_optimizer": True})
    assert torch.equal(ps[0], torch.ones(4))
    assert ck.fused_adamw_multi_or_none(ps, gs, sc, m1, m2, coeff=0.01,
                                        **KW) is ps
    assert not torch.equal(ps[0], torch.ones(4))


# ---------------------------------------------------------------------------
# the work split, mirrored

def _mirror_layout(cap, chunk=4096):
    """csrc/adamw.cu's Table for `cap` entries as the compiler lays it out
    (each array at its natural alignment, in declaration order): bytes,
    capacity, chunk, offsets."""
    off, at = {}, 0
    for field, size in (("p", 8), ("g", 8), ("m1", 8), ("m2", 8), ("n", 8),
                        ("coeff", 4), ("lrf", 4), ("chunk0", 4),
                        ("flags", 1)):
        at = -(-at // size) * size
        off[field] = at
        at += size * (cap + (field == "chunk0"))
    return (-(-at // 8) * 8, cap, chunk, off)


def _decode(table, layout, count):
    size, cap, chunk, off = layout
    view = lambda f, dt, k: np.frombuffer(  # noqa: E731
        table[off[f]:off[f] + k * np.dtype(dt).itemsize].tobytes(), dt)
    return {"n": view("n", np.int64, count),
            "chunk0": view("chunk0", np.int32, count + 1),
            "flags": view("flags", np.uint8, count),
            "coeff": view("coeff", np.float32, count),
            "lrf": view("lrf", np.float32, count),
            "p": view("p", np.uint64, count)}


def _kernel_split(t, chunk):
    """Each CTA's (tensor, first element, elements), as adamw_kernel
    finds them: the last entry whose first chunk is <= blockIdx.x."""
    out = []
    count = len(t["n"])
    for c in range(int(t["chunk0"][count])):
        lo, hi = 0, count - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if t["chunk0"][mid] <= c:
                lo = mid
            else:
                hi = mid - 1
        begin = (c - int(t["chunk0"][lo])) * chunk
        out.append((lo, begin, min(chunk, int(t["n"][lo]) - begin)))
    return out


@pytest.mark.parametrize("chunk", [4096, 16])
def test_table_chunks_cover_every_element_once(monkeypatch, chunk):
    layout = _mirror_layout(576, chunk)
    monkeypatch.setattr(ck, "_ADAMW_LAYOUT", [layout])
    ns = [1, 3, 16, 17, 4095, 4096, 4097, 12289, 100003, 2]
    table = ck._adamw_table(list(range(4 * len(ns))), ns,
                            [0.0, 0.01] * 5, [1.0, 0.5] * 5,
                            [3, 0, 1, 2, 0, 3, 2, 1, 0, 0])
    assert table.nbytes == layout[0] == 30536
    t = _decode(table, layout, len(ns))
    assert list(t["n"]) == ns and list(t["flags"]) == [3, 0, 1, 2, 0, 3, 2,
                                                       1, 0, 0]
    assert list(t["p"]) == list(range(0, 4 * len(ns), 4))
    np.testing.assert_array_equal(t["lrf"], np.float32([1.0, 0.5] * 5))
    seen = [np.zeros(n, np.int64) for n in ns]
    for i, begin, length in _kernel_split(t, chunk):
        assert 0 < length <= chunk
        seen[i][begin:begin + length] += 1
    assert all((s == 1).all() for s in seen)


def test_plan_groups_by_type_pair_and_splits_past_capacity(monkeypatch):
    """One launch a (parameter, gradient) type pair in order of first
    appearance, consecutive launches past the table's capacity (3 here);
    the vector flag only where all four pointers are 16-byte aligned; a
    second call over the same tensors reuses the plan."""
    monkeypatch.setattr(ck, "_ADAMW_LAYOUT", [_mirror_layout(3)])
    monkeypatch.setattr(ck, "_ADAMW_PLANS", {})
    buf = torch.zeros(65)
    types = [(torch.bfloat16, torch.bfloat16)] * 4 + [
        (torch.float32, torch.float32)] * 2 + [(torch.bfloat16,
                                                torch.float32)]
    ps = [torch.zeros(64, dtype=p) for p, _ in types]
    gs = [torch.zeros(64, dtype=g) for _, g in types]
    m1 = [torch.zeros(64) for _ in types]
    m2 = [torch.zeros(64) for _ in types]
    m2[5] = buf[1:]                     # 4 bytes off alignment
    attrs = ([0.01] * 7, [False] * 7, [1.0] * 7)
    launches = ck._adamw_plan(ps, gs, m1, m2, *attrs)
    assert [(c, pt, gt) for _, c, pt, gt, _ in launches] == [
        (3, 1, 1), (1, 1, 1), (2, 0, 0), (1, 1, 0)]
    layout = ck._ADAMW_LAYOUT[0]
    flags_f32 = _decode(launches[2][0], layout, 2)["flags"]
    aligned = all(t.data_ptr() % 16 == 0 for t in (ps[4], gs[4], m1[4],
                                                   m2[4]))
    assert list(flags_f32) == [2 if aligned else 0, 0]
    assert ck._adamw_plan(ps, gs, m1, m2, *attrs) is launches
    gs2 = [g.clone() for g in gs]       # other tensors: a new plan
    assert ck._adamw_plan(ps, gs2, m1, m2, *attrs) is not launches


# ---------------------------------------------------------------------------
# the optimizer

def _named_pair(name, seed=0, **extra):
    """Three float32 parameters (named w, b, ln) in both packages and
    their optimizers at lr 0.01."""
    rs = np.random.RandomState(seed)
    init = [rs.randn(*s).astype(np.float32) for s in ((4, 5), (5,), (7,))]
    jps = [JParam(a, name=n) for a, n in zip(init, ("w", "b", "ln"))]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    for p, n in zip(tps, ("w", "b", "ln")):
        p.qualname = n
    jkw = {k: v(jopt) if callable(v) and k == "grad_clip" else v
           for k, v in extra.items()}
    tkw = {k: v(topt) if callable(v) and k == "grad_clip" else v
           for k, v in extra.items()}
    jo = getattr(jopt, name)(learning_rate=0.01, parameters=jps, **jkw)
    to = getattr(topt, name)(learning_rate=0.01, parameters=tps,
                             device="cpu", **tkw)
    return jps, tps, jo, to, rs


OPT_CASES = {
    "Adam": ("Adam", {}, {}),
    "AdamW-decay-fun": ("AdamW", {"apply_decay_param_fun":
                                  lambda n: n == "w"}, {}),
    "AdamW-global-norm": ("AdamW", {"grad_clip": lambda lib:
                                    lib.ClipGradByGlobalNorm(0.05)},
                          {"need_clip": {"ln": False}}),
    "AdamW-lr-factors": ("AdamW", {}, {"lr": {"w": 0.5, "ln": 0.25}}),
    "Adam-all": ("Adam", {"grad_clip": lambda lib:
                          lib.ClipGradByGlobalNorm(0.05)},
                 {"need_clip": {"b": False}, "lr": {"b": 0.5}}),
    "AdamW-all": ("AdamW", {"apply_decay_param_fun": lambda n: n != "ln",
                            "grad_clip": lambda lib:
                            lib.ClipGradByGlobalNorm(0.05)},
                  {"need_clip": {"w": False}, "lr": {"ln": 0.5}}),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_holds_the_reference(case):
    """3 steps through the optimizer's one gate call a step against the
    JAX package's rule: parameters and moments within rtol 1e-6 / atol
    1e-7 after every step."""
    name, kw, attrs = OPT_CASES[case]
    jps, tps, jo, to, rs = _named_pair(name, **kw)
    for ps in (jps, tps):
        by = {("w", "b", "ln")[i]: p for i, p in enumerate(ps)}
        for n, v in attrs.get("need_clip", {}).items():
            by[n].need_clip = v
        for n, v in attrs.get("lr", {}).items():
            by[n].optimize_attr = {"learning_rate": v}
    for step in range(3):
        grads = [(rs.randn(*p.shape) * 0.1).astype(np.float32) for p in tps]
        for p, g in zip(jps, grads):
            p._grad = JTensor(jnp.asarray(g), _internal=True)
        for p, g in zip(tps, grads):
            p.grad = torch.from_numpy(g)
        jo.step()
        to.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp._data), rtol=1e-6,
                                       atol=1e-7, err_msg="step %d" % step)
            for n, a in to._get_accumulators(tp).items():
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(jo._accumulators[id(jp)][n]),
                    rtol=1e-6, atol=1e-7, err_msg="%s step %d" % (n, step))


def _mixed_model_params(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i, dt in enumerate((torch.float32, torch.bfloat16, torch.float16,
                            torch.float32, torch.bfloat16)):
        p = torch.nn.Parameter(torch.from_numpy(
            rs.randn(3 + 5 * i).astype(np.float32)).to(dt))
        p.qualname = "p%d" % i
        out.append(p)
    out[1].optimize_attr = {"learning_rate": 0.5}
    out[3].need_clip = False
    return out


def _run_mixed(steps):
    """`steps` AdamW steps over `_mixed_model_params` (a decay exemption,
    the global-norm clip, an lr factor), gradients from numpy."""
    ps = _mixed_model_params()
    opt = topt.AdamW(learning_rate=0.01, parameters=ps, device="cpu",
                     apply_decay_param_fun=lambda n: n != "p2",
                     grad_clip=topt.ClipGradByGlobalNorm(0.05))
    rs = np.random.RandomState(1)
    for _ in range(steps):
        for p in ps:
            p.grad = torch.from_numpy(
                rs.randn(p.numel()).astype(np.float32)).to(p.dtype)
        opt.step()
    return ps, opt


@pytest.mark.parametrize("fused", [True, False])
def test_apply_updates_calls_the_gate_once_a_type_pair(monkeypatch, fused):
    """With use_fused_optimizer on, a step over float32, bfloat16 and
    float16 parameters makes one gate call a (parameter dtype, gradient
    dtype) group (3), each over all its tensors, and no per-tensor plain
    call from the optimizer; off, the gate returns None and the plain
    rule runs once a tensor. Both routes give the same bits."""
    import paddle_tpu_torch.optimizer as omod
    gate_calls, plain_calls = [], []
    gate, plain = omod.fused_adamw_multi_or_none, omod.adamw_plain_scalars

    def spy_gate(params, *a, **k):
        gate_calls.append([p.dtype for p in params])
        return gate(params, *a, **k)

    def spy_plain(param, *a, **k):
        plain_calls.append(param.dtype)
        return plain(param, *a, **k)
    monkeypatch.setattr(omod, "fused_adamw_multi_or_none", spy_gate)
    monkeypatch.setattr(omod, "adamw_plain_scalars", spy_plain)
    flags.set_flags({"use_fused_optimizer": fused})
    try:
        ps, _ = _run_mixed(steps=2)
    finally:
        flags.set_flags({"use_fused_optimizer": True})
    assert len(gate_calls) == 2 * 3
    assert sorted(map(len, gate_calls[:3])) == [1, 2, 2]
    assert all(len(set(c)) == 1 for c in gate_calls)
    assert len(plain_calls) == (0 if fused else 2 * 5)
    monkeypatch.undo()
    flags.set_flags({"use_fused_optimizer": not fused})
    try:
        other, _ = _run_mixed(steps=2)
    finally:
        flags.set_flags({"use_fused_optimizer": True})
    assert all(torch.equal(a, b) for a, b in zip(ps, other))
