"""Program passes (counterpart of paddle_tpu/static/passes.py:
`register_pass`, `PassBase`, `apply_pass`, `PassManager`, the removal
helpers, `delete_dropout_pass` :115, `amp_bf16_pass` :147 and the
inference fusion passes :182-505).

A pass rewrites `Program.ops` (the recorded OpRecords) before a program
runs. The fusion passes (conv + batch-norm fold, matmul + bias into
fc_op, add + activation into fused_elemwise_add_act) are export-time
rewrites: `save_inference_model` runs them on a clone, so the saved
artifact is smaller and the live training program stays as it was. A
pass replaces records rather than mutating them (`Program.clone` shares
records), and never rebuilds an op whose function another pass wrapped
(`_pristine`).

Not ported yet: transpose_cancel_pass, scale_merge_pass and the quant
passes (delete_quant_pass, quant_insert_pass).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ..framework.dispatch import OPS
from .program import OpRecord, Program

__all__ = ["register_pass", "PassBase", "apply_pass", "PassManager",
           "PASS_REGISTRY", "INFERENCE_FUSION_PASSES",
           "apply_inference_fusion"]

PASS_REGISTRY: Dict[str, Callable[..., "PassBase"]] = {}


def register_pass(name):
    def deco(cls):
        cls.name = name
        PASS_REGISTRY[name] = cls
        return cls
    return deco


class PassBase:
    """reference: ir/pass.h Pass::Apply: rewrite and return the program."""

    name = ""

    def apply(self, program: Program) -> Program:
        raise NotImplementedError

    def __call__(self, program):
        return self.apply(program)


def apply_pass(program: Program, name: str, **attrs) -> Program:
    if name not in PASS_REGISTRY:
        raise KeyError("unknown pass %r; registered: %s"
                       % (name, sorted(PASS_REGISTRY)))
    out = PASS_REGISTRY[name](**attrs).apply(program)
    program.version += 1
    return out if out is not None else program


class PassManager:
    """A list of passes (names or PassBase objects) applied in order; each
    bumps the program's version, so that an executor builds it anew."""

    def __init__(self, passes: List):
        self.passes = list(passes)

    def apply(self, program: Program) -> Program:
        for p in self.passes:
            if isinstance(p, str):
                program = apply_pass(program, p)
            else:
                program = p.apply(program) or program
                program.version += 1
        return program


def _rewire(ops, mapping):
    """Point var references at their replacements ({old: (kind, ref)})."""
    for op in ops:
        op.in_refs = [mapping.get(ref, (kind, ref))
                      if kind != "const" else (kind, ref)
                      for kind, ref in op.in_refs]


def _resolve_chains(mapping):
    """Chase chains of removed ops so that every entry points at a
    surviving ref."""
    for k in list(mapping):
        kind, ref = mapping[k]
        while kind != "const" and ref in mapping:
            kind, ref = mapping[ref]
        mapping[k] = (kind, ref)
    return mapping


def _remove_and_rewire(program, mapping, drop_ids=None):
    """Apply a removal pass's {removed output: surviving input ref}: drop
    the ops, rewire their consumers, and keep the mapping as the
    program's aliases, so that a fetch of a removed var still resolves."""
    _resolve_chains(mapping)
    if drop_ids is None:
        removed = set(mapping)
        program.ops = [o for o in program.ops
                       if not (set(o.out_names) & removed)]
    else:
        program.ops = [o for o in program.ops if id(o) not in drop_ids]
    _rewire(program.ops, mapping)
    program.aliases.update(mapping)
    return program


@register_pass("delete_dropout_pass")
class DeleteDropoutPass(PassBase):
    """Remove dropout ops, their consumers reading the dropout's input
    (reference: ir/delete_dropout_op_pass.cc)."""

    _DROPOUT_TYPES = ("dropout_op",)

    def apply(self, program):
        mapping = {op.out_names[0]: op.in_refs[0] for op in program.ops
                   if op.op_type in self._DROPOUT_TYPES}
        return _remove_and_rewire(program, mapping)


def _wrap_bf16(fn):
    def wrapped(*args, **attrs):
        cast = [a.to(torch.bfloat16) if isinstance(a, torch.Tensor)
                and a.dtype == torch.float32 else a for a in args]
        outs = fn(*cast, **attrs)
        single = not isinstance(outs, tuple)
        back = tuple(o.float() if isinstance(o, torch.Tensor)
                     and o.dtype == torch.bfloat16 else o
                     for o in ((outs,) if single else outs))
        return back[0] if single else back
    return wrapped


@register_pass("amp_bf16_pass")
class AmpBf16Pass(PassBase):
    """Static AMP: matmul-class ops compute in bfloat16 (their float32
    inputs cast), their outputs back to float32 (reference: the static
    AMP rewrite, a compute-dtype rewrite of the records)."""

    DEFAULT_LIST = ("matmul_v2", "conv2d_op", "conv2d_transpose_op")

    def __init__(self, op_types=None):
        self.op_types = tuple(op_types or self.DEFAULT_LIST)

    def apply(self, program):
        for op in program.ops:
            if op.op_type in self.op_types and \
                    not getattr(op.fn, "_pt_bf16", False):
                op.fn = _wrap_bf16(op.fn)
                op.fn._pt_bf16 = True
        return program


@register_pass("identity_scale_clean_pass")
class IdentityScaleCleanPass(PassBase):
    """Remove identity and scale(1.0, +0) ops, their consumers rewired
    (reference: ir/identity_scale_op_clean_pass.cc)."""

    def apply(self, program):
        mapping = {}
        for op in program.ops:
            is_noop = (op.op_type == "identity"
                       or (op.op_type in ("scale", "scale_op")
                           and float(op.attrs.get("scale", 1.0)) == 1.0
                           and float(op.attrs.get("bias", 0.0)) == 0.0))
            if is_noop and len(op.out_names) == 1 and op.in_refs:
                mapping[op.out_names[0]] = op.in_refs[0]
        return _remove_and_rewire(program, mapping)


def _producer_uses(program):
    producer, uses = {}, {}
    for op in program.ops:
        for n in op.out_names:
            producer[n] = op
        for kind, ref in op.in_refs:
            if kind != "const":
                uses[ref] = uses.get(ref, 0) + 1
    return producer, uses


_UNRESOLVED = object()


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _cap_array(caps_by_name, ref):
    """The value of a ("cap" | "const", x) ref as numpy, or _UNRESOLVED
    for a graph var."""
    kind, v = ref
    if kind == "const":
        return _host(v)
    if kind == "cap" and v in caps_by_name:
        return _host(caps_by_name[v])
    return _UNRESOLVED


def _const_eval(caps_by_name, producer, ref, depth=4):
    """`ref` as a numpy array where its subgraph reads parameters and
    constants only (a bias through reshape2), else _UNRESOLVED."""
    v = _cap_array(caps_by_name, ref)
    if v is not _UNRESOLVED:
        return v
    op = producer.get(ref[1])
    if op is None or depth <= 0:
        return _UNRESOLVED
    ins = [_const_eval(caps_by_name, producer, r, depth - 1)
           for r in op.in_refs]
    if any(i is _UNRESOLVED for i in ins):
        return _UNRESOLVED
    try:
        outs = op.fn(*[torch.from_numpy(np.asarray(i))
                       if isinstance(i, np.ndarray) else i for i in ins],
                     **op.attrs)
    except Exception:
        return _UNRESOLVED
    outs = outs if isinstance(outs, tuple) else (outs,)
    return _host(outs[op.out_names.index(ref[1])])


def _add_capture(program, arr, like):
    """A new captured constant holding `arr`, on `like`'s device."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)
    t.persistable = True
    return program._capture(t)


def _caps_by_name(program):
    return {program.capture_names[i]: t
            for i, t in program.captured.items()}


def _pristine(op) -> bool:
    """op.fn is its registry op's own function: a fusion pass does not
    rebuild an op whose function another pass wrapped (amp_bf16's
    casts)."""
    prim = OPS.get(op.op_type)
    return prim is not None and op.fn is prim.fn


@register_pass("conv_bn_fuse_pass")
class ConvBnFusePass(PassBase):
    """Fold an inference batch norm into the convolution before it:
    w' = w * (gamma / sqrt(var + eps)) along the output channels,
    b' = beta - (mean - conv bias) * (gamma / sqrt(var + eps)), one
    elementwise_add of b' in the batch norm's place (reference:
    ir/conv_bn_fuse_pass.cc; the arithmetic in float64 numpy, then the
    weight's dtype). The fold rescales the convolution's own output, so a
    `protected` name (the export's fetches) among the conv's or the bias
    add's outputs vetoes it."""

    def __init__(self, protected=()):
        self.protected = frozenset(protected)

    def apply(self, program):
        producer, uses = _producer_uses(program)
        caps = _caps_by_name(program)
        conv_replacements = {}
        for i, op in enumerate(program.ops):
            if op.op_type != "batch_norm_infer" or not _pristine(op):
                continue
            kind, ref = op.in_refs[0]
            if kind != "var":
                continue
            p = producer.get(ref)
            conv, conv_bias, conv_out = None, None, ref
            if p is not None and p.op_type == "conv2d_op":
                conv = p
            elif p is not None and p.op_type == "elementwise_add" \
                    and len(p.in_refs) == 2 and _pristine(p):
                for xi, bi in ((0, 1), (1, 0)):
                    k2, r2 = p.in_refs[xi]
                    cand = producer.get(r2) if k2 == "var" else None
                    if cand is not None and cand.op_type == "conv2d_op" \
                            and uses.get(r2, 0) == 1:
                        b = _const_eval(caps, producer, p.in_refs[bi])
                        if b is not _UNRESOLVED and b is not None:
                            conv, conv_bias, conv_out = cand, b, r2
                        break
            if conv is None or uses.get(ref, 0) != 1 \
                    or len(conv.in_refs) != 2 \
                    or int(conv.attrs.get("groups", 1)) != 1 \
                    or not _pristine(conv) \
                    or id(conv) in conv_replacements:
                continue
            if self.protected & ({conv_out, ref} | set(conv.out_names)):
                continue
            if conv.in_refs[1][0] != "cap":
                continue
            w = _cap_array(caps, conv.in_refs[1])
            vals = [_cap_array(caps, r) for r in op.in_refs[1:5]]
            if w is _UNRESOLVED or any(v is _UNRESOLVED for v in vals):
                continue
            gamma, beta, mean, var = vals
            if mean is None or var is None:
                continue
            n_ch = int(mean.shape[0])
            if conv_bias is not None:
                if conv_bias.size != n_ch:
                    continue
                conv_bias = np.asarray(conv_bias).reshape(-1)
            eps = float(op.attrs.get("epsilon", 1e-5))
            channel_last = bool(conv.attrs.get("channel_last", False))
            inv = 1.0 / np.sqrt(np.asarray(var, np.float64) + eps)
            scale = inv if gamma is None else gamma * inv
            if channel_last:
                w_new = w * scale.reshape((1,) * (w.ndim - 1) + (-1,))
            else:
                w_new = w * scale.reshape((-1,) + (1,) * (w.ndim - 1))
            shift = mean if conv_bias is None else mean - conv_bias
            bias = (0.0 if beta is None else beta) - shift * scale
            nsp = w.ndim - 2
            bias = bias.reshape((-1,)) if channel_last \
                else bias.reshape((1, -1) + (1,) * nsp)
            like = caps[conv.in_refs[1][1]]
            w_name = _add_capture(program, w_new.astype(w.dtype), like)
            b_name = _add_capture(program, bias.astype(w.dtype), like)
            conv_replacements[id(conv)] = OpRecord(
                conv.op_type, conv.fn, dict(conv.attrs),
                [conv.in_refs[0], ("cap", w_name)], list(conv.out_names))
            program.ops[i] = OpRecord(
                "elementwise_add", OPS["elementwise_add"].fn, {},
                [("var", conv_out), ("cap", b_name)], list(op.out_names))
        if conv_replacements:
            program.ops = [conv_replacements.get(id(o), o)
                           for o in program.ops]
        return program


@register_pass("fc_fuse_pass")
class FcFusePass(PassBase):
    """matmul_v2 + a parameter bias add -> one fc_op (reference:
    ir/fc_fuse_pass.cc); the matmul stays as a dead producer, so that its
    output remains fetchable."""

    def apply(self, program):
        producer, uses = _producer_uses(program)
        for i, op in enumerate(program.ops):
            if op.op_type != "elementwise_add" or len(op.in_refs) != 2 \
                    or not _pristine(op):
                continue
            for xi, bi in ((0, 1), (1, 0)):
                kind, ref = op.in_refs[xi]
                mm = producer.get(ref) if kind == "var" else None
                if mm is not None and mm.op_type == "matmul_v2" \
                        and _pristine(mm) and uses.get(ref, 0) == 1 \
                        and op.in_refs[bi][0] != "var":
                    program.ops[i] = OpRecord(
                        "fc_op", OPS["fc_op"].fn,
                        {"transpose_x": mm.attrs.get("transpose_x", False),
                         "transpose_y": mm.attrs.get("transpose_y", False)},
                        [mm.in_refs[0], mm.in_refs[1], op.in_refs[bi]],
                        list(op.out_names))
                    break
        return program


@register_pass("fuse_elewise_add_act_pass")
class ElewiseAddActFusePass(PassBase):
    """elementwise_add + an activation -> fused_elemwise_add_act
    (reference: ir/fuse_elewise_add_act_pass.cc); the add stays as a dead
    producer."""

    ACTS = ("relu", "relu6", "gelu", "sigmoid", "tanh")

    def apply(self, program):
        producer, uses = _producer_uses(program)
        for i, op in enumerate(program.ops):
            if op.op_type not in self.ACTS or not op.in_refs \
                    or not _pristine(op):
                continue
            kind, ref = op.in_refs[0]
            addop = producer.get(ref) if kind == "var" else None
            if addop is None or addop.op_type != "elementwise_add" \
                    or uses.get(ref, 0) != 1 or not _pristine(addop):
                continue
            program.ops[i] = OpRecord(
                "fused_elemwise_add_act", OPS["fused_elemwise_add_act"].fn,
                {"act": op.op_type, "act_attrs": dict(op.attrs)},
                list(addop.in_refs), list(op.out_names))
        return program


INFERENCE_FUSION_PASSES = ("identity_scale_clean_pass", "conv_bn_fuse_pass",
                           "fc_fuse_pass", "fuse_elewise_add_act_pass")


def apply_inference_fusion(program, protected=()):
    """The export-time fusion passes on a deep clone of the program's
    records (the live program stays as it was); `protected`: fetch names
    whose values must not change (they veto a conv + batch-norm fold)."""
    p = program.clone()
    p.ops = [OpRecord(o.op_type, o.fn, dict(o.attrs), list(o.in_refs),
                      list(o.out_names)) for o in program.ops]
    for name in INFERENCE_FUSION_PASSES:
        if name == "conv_bn_fuse_pass":
            p = apply_pass(p, name, protected=protected)
        else:
            p = apply_pass(p, name)
    return p
