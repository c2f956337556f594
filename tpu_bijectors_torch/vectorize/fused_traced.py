"""Generic TRACED entries of the whole-model fused evaluation, PyTorch
counterpart of `tpu_bijectors/vectorize/fused_traced.py`.

A leaf with no slab or loop form (a truncated prior, Kumaraswamy, a
mixture, joint order statistics, ...) is served when its linked density
can be traced. `_pe_split_admit`:

1. traces the density with `make_fx`, v the only input (the parameters
   closed over are constants of the graph);
2. partial evaluation: a node that v does not reach is evaluated once;
   those that feed a v-dependent node become the entry's residuals, at
   most 16 floats each and floating point only (a truncation's cdf
   normaliser, lgamma constants);
3. admission: every v-dependent node is an elementwise op of
   `fused_decomp._OPS` or a view, concatenation or reduction the
   scalarizer unrolls, of rank <= 1, within JAX's op budgets (256 for the
   value, 512 with the tangent rules); the output is one scalar;
4. scalarization: the v-dependent part becomes a straight-line tape of
   scalar opcodes (slice, cat, flip, cumsum, sum, all and logsumexp
   unrolled on the host), constant operations folded;
5. slot allocation by liveness, so the tape needs few registers (at most
   `fused_decomp.MAX_SLOTS`).

The tape (`Tape`) runs in the loop kind `traced` of the whole-model
kernels (kernels/csrc/traced_tape.cuh): a scalar entry over each of its n
rows (an IID block) with v = the row, a vector entry (linked length
2-16) once over its L rows. Partials come from dual numbers: a unit
tangent on each input in turn. `run_tape_plain` evaluates the same tape
with the same rules in torch ops over (rows, B): the plain version of the
loop kind.

Word layout of a tape: a header {instructions, slots, output slot,
inputs, vector, output carries a tangent}, then five int32 words an
instruction {opcode | tangent bits, destination slot, operands a, b, c}.
An operand >= 0 is a slot, ~k the entry's constant k (its residuals and
the literals of the trace, in its parameter block). Tangent bits: 1 << 8,
9, 10 the operand a, b, c carries a tangent; 1 << 11 the result does.
"""

from __future__ import annotations

import heapq
import struct
from dataclasses import dataclass

import torch

from ..dists.base import first_param
from . import fused_decomp as fd
from .fused_base import _Entry, _Unsupported

HEADER = 6
WORDS = 5
TAN_A, TAN_B, TAN_C, TAN_OUT = 1 << 8, 1 << 9, 1 << 10, 1 << 11
OP_MASK = 0xFF

_aten = torch.ops.aten
# views and copies: the same elements, perhaps reshaped or broadcast
_SAME = {
    _aten.unsqueeze.default, _aten.squeeze.default, _aten.squeeze.dim, _aten.squeeze.dims,
    _aten.view.default, _aten._unsafe_view.default, _aten.reshape.default,
    _aten.expand.default, _aten.clone.default, _aten.alias.default, _aten.detach.default,
    _aten.lift_fresh_copy.default, _aten.t.default, _aten.permute.default,
}
_FILL = {
    _aten.full_like.default: lambda a, k: a[1],
    _aten.zeros_like.default: lambda a, k: 0.0,
    _aten.ones_like.default: lambda a, k: 1.0,
    _aten.new_zeros.default: lambda a, k: 0.0,
    _aten.new_ones.default: lambda a, k: 1.0,
    _aten.new_full.default: lambda a, k: a[2],
}


@dataclass(frozen=True, eq=False)
class Tape:
    """A traced entry's program: `words` (header and instructions),
    `consts` (its constants, float64 values: residuals, then literals),
    `n_in` inputs (1 for a scalar entry, L for a vector one) and the value
    and derivative operation counts the budgets were held to."""

    words: tuple
    consts: tuple
    n_in: int
    vector: bool
    value_ops: int
    deriv_ops: int

    @property
    def n_ins(self):
        return self.words[0]

    @property
    def n_slots(self):
        return self.words[1]

    def params(self, dtype):
        return torch.tensor(self.consts, dtype=torch.float64).to(dtype)

    def instructions(self):
        """[(opcode name, tangent bits, dst, a, b, c)] of the program."""
        out = []
        for i in range(self.n_ins):
            w = self.words[HEADER + WORDS * i: HEADER + WORDS * (i + 1)]
            out.append((fd.BY_CODE[w[0] & OP_MASK], w[0] & ~OP_MASK, *w[1:]))
        return out


# ---------------------------------------------------------------------------
# the plain evaluator
# ---------------------------------------------------------------------------


def run_tape_plain(tape, consts, inputs, tangents=None, on_step=None):
    """Evaluate `tape` in torch ops: `inputs` the n_in input tensors (any
    common shape), `tangents` None (value only) or their tangents; consts
    a tensor of the tape's constants. Returns (value, tangent or None); the
    tangent is None where the output carries none. `on_step(value,
    tangent)`, where given, sees every instruction's result (an error
    bound can sum their magnitudes)."""
    n_slots = tape.n_slots
    sv = [None] * n_slots
    st = [None] * n_slots
    for i, x in enumerate(inputs):
        sv[i] = x
        st[i] = None if tangents is None else tangents[i]
    dual = tangents is not None
    ks = [consts[k] for k in range(consts.numel())]
    for name, bits, dst, *opd in tape.instructions():
        op = fd.OPS[name]
        vals, tans = [], []
        for j, (a, bit) in enumerate(zip(opd, (TAN_A, TAN_B, TAN_C))):
            if j >= op.arity:
                vals.append(None)
                tans.append(None)
            elif a >= 0:
                vals.append(sv[a])
                tans.append(st[a] if dual and bits & bit else None)
            else:
                vals.append(ks[~a])
                tans.append(None)
        r, t = fd.apply_op(name, *vals, *tans)
        sv[dst] = r
        st[dst] = t if dual and bits & TAN_OUT else None
        if on_step is not None:
            on_step(r, st[dst])
    out = tape.words[2]
    t = st[out] if dual and tape.words[5] else None
    return sv[out], t


def traced_val_par(tape, consts, V, value, partial, on_step=None):
    """The plain version of one traced loop entry over its rows V (rows,
    B): (its value (B,) or None, its partials (rows, B) or None). A scalar
    entry's rows each run the tape (unit tangents, one per row); a vector
    entry runs once over its L rows, with L unit tangents at once.
    `on_step` as `run_tape_plain`'s."""
    if not tape.vector:
        tans = [torch.ones_like(V)] if partial else None
        val, t = run_tape_plain(tape, consts, [V], tans, on_step)
        val = torch.broadcast_to(val, V.shape)
        par = None
        if partial:
            par = torch.zeros_like(V) if t is None else torch.broadcast_to(t, V.shape)
        return (val.sum(0) if value else None), par
    L = V.shape[0]
    tans = None
    if partial:
        eye = torch.eye(L, dtype=V.dtype, device=V.device)
        tans = [eye[:, j: j + 1].expand(L, V.shape[1]) for j in range(L)]
    val, t = run_tape_plain(tape, consts, list(V), tans, on_step)
    val = torch.broadcast_to(val, V.shape[1:])
    par = None
    if partial:
        par = torch.zeros_like(V) if t is None else torch.broadcast_to(t, V.shape)
    return (val if value else None), par


# ---------------------------------------------------------------------------
# tracing, partial evaluation and admission
# ---------------------------------------------------------------------------


@dataclass
class _Val:
    """A v-dependent (or constant) value: its shape (rank <= 1) and one
    reference an element (a register >= 0, a constant ~k)."""

    shape: tuple
    refs: list


class _TapeWriter:
    def __init__(self, n_in):
        self.consts, self._const_at = [], {}
        self.ins = []  # [name, dst, a, b, c]
        self.has_t = {i: True for i in range(n_in)}
        self.n_regs = n_in

    def const(self, v):
        v = float(v)
        key = struct.pack("<d", v)
        if key not in self._const_at:
            self._const_at[key] = len(self.consts)
            self.consts.append(v)
        return ~self._const_at[key]

    def emit(self, name, *opd):
        op = fd.OPS[name]
        if len(opd) != op.arity:
            raise _Unsupported(f"{name} with {len(opd)} operands")
        if all(a < 0 for a in opd):
            # constants only: fold on the host in float64
            xs = [torch.tensor(self.consts[~a], dtype=torch.float64) for a in opd]
            xs += [None] * (3 - len(xs))
            return self.const(op.value(*xs))
        r = self.n_regs
        self.n_regs += 1
        self.has_t[r] = op.tangent and any(a >= 0 and self.has_t[a] for a in opd)
        self.ins.append([name, r, *opd, *([None] * (3 - len(opd)))])
        return r


def _shape_of(t):
    shape = tuple(t.shape)
    if len(shape) > fd.MAX_RANK:
        raise _Unsupported(f"a value of rank {len(shape)} on the state's path")
    return shape


def _bcast(vals, shape):
    """Each _Val's refs broadcast to `shape` (rank <= 1)."""
    n = shape[0] if shape else 1
    out = []
    for v in vals:
        if len(v.refs) == n:
            out.append(v.refs)
        elif len(v.refs) == 1:
            out.append(v.refs * n)
        else:
            raise _Unsupported(f"broadcast of {v.shape} to {shape}")
    return out


def _dim(d, rank):
    return d + rank if d < 0 else d


class _Scalarizer:
    """Walks the trace's v-dependent nodes in order and unrolls them into
    the writer's scalar tape."""

    def __init__(self, gm, env, vdep, n_in):
        self.gm, self.env, self.vdep = gm, env, vdep
        self.b = _TapeWriter(n_in)
        self.vals = {}
        self.value_ops = self.deriv_ops = 0

    def arg(self, a):
        """A node argument as a _Val: v-dependent, or a residual (a known
        tensor, its elements constants), or a Python number."""
        b = self.b
        if isinstance(a, torch.fx.Node):
            if a in self.vals:
                return self.vals[a]
            t = self.env[a]
            if not isinstance(t, torch.Tensor):
                return _Val((), [b.const(t)])
            if not t.is_floating_point():
                raise _Unsupported(f"a residual of dtype {t.dtype}")
            if t.numel() > fd.MAX_RESIDUAL or t.dim() > fd.MAX_RANK:
                raise _Unsupported(f"a residual of shape {tuple(t.shape)}")
            flat = t.detach().double().reshape(-1).tolist()
            v = _Val(tuple(t.shape), [b.const(x) for x in flat])
            self.vals[a] = v
            return v
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            raise _Unsupported(f"an argument {a!r}")
        return _Val((), [b.const(a)])

    def elementwise(self, node, name, operands):
        shape = _shape_of(self.env[node])
        refs = _bcast(operands, shape)
        return _Val(shape, [self.b.emit(name, *rs) for rs in zip(*refs)])

    def run(self):
        for node in self.gm.graph.nodes:
            if node.op == "call_function" and node in self.vdep:
                self.vals[node] = self.node(node)
                self.value_ops += 1
        out = self.gm.graph.output_node().args[0]
        if isinstance(out, (tuple, list)):
            out = out[0]
        if out not in self.vals:
            raise _Unsupported("a density that does not depend on the state")
        v = self.vals[out]
        if v.shape != () or v.refs[0] < 0:
            raise _Unsupported(f"a density of shape {v.shape}")
        return v.refs[0]

    def node(self, node):
        t, args, kw = node.target, node.args, node.kwargs
        b = self.b
        name = fd._OPS.get(t)
        if name is not None:
            self.deriv_ops += 1 + fd.OPS[name].dual_ops
            return self.elementwise_node(node, name, args, kw)
        self.deriv_ops += 2
        if t in _SAME:
            x = self.arg(args[0])
            shape = _shape_of(self.env[node])
            return _Val(shape, _bcast([x], shape)[0])
        if t is _aten._to_copy.default:
            x = self.arg(args[0])
            to = kw.get("dtype")
            if self.env[args[0]].dtype == torch.bool and to is not None and to.is_floating_point:
                return _Val(x.shape, [b.emit("b2f", r) for r in x.refs])
            return x
        if t in _FILL:
            shape = _shape_of(self.env[node])
            c = b.const(_FILL[t](args, kw))
            return _Val(shape, [c] * (shape[0] if shape else 1))
        if t is _aten.slice.Tensor:
            x = self.arg(args[0])
            dim = args[1] if len(args) > 1 else 0
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            if len(x.shape) != 1 or _dim(dim, 1) != 0:
                raise _Unsupported("a slice of rank other than 1")
            refs = x.refs[slice(start, end, step)]
            return _Val((len(refs),), refs)
        if t is _aten.select.int:
            x = self.arg(args[0])
            if len(x.shape) != 1 or _dim(args[1], 1) != 0:
                raise _Unsupported("a select of rank other than 1")
            return _Val((), [x.refs[args[2]]])
        if t is _aten.cat.default:
            parts = [self.arg(a) for a in args[0]]
            if any(len(p.shape) != 1 for p in parts):
                raise _Unsupported("a cat of rank other than 1")
            refs = [r for p in parts for r in p.refs]
            return _Val((len(refs),), refs)
        if t is _aten.flip.default:
            x = self.arg(args[0])
            return _Val(x.shape, x.refs[::-1])
        if t is _aten.cumsum.default:
            x = self.arg(args[0])
            out, acc = [], None
            for r in x.refs:
                acc = r if acc is None else b.emit("add", acc, r)
                out.append(acc)
            return _Val(x.shape, out)
        if t in (_aten.sum.default, _aten.sum.dim_IntList, _aten.all.default, _aten.all.dim,
                 _aten.all.dims, _aten.any.default, _aten.any.dim, _aten.any.dims,
                 _aten.logsumexp.default):
            x = self.arg(args[0])
            shape = _shape_of(self.env[node])
            if shape not in ((), (1,)):
                raise _Unsupported(f"a reduction to {shape}")
            if t is _aten.logsumexp.default:
                r = self.logsumexp(x.refs)
            else:
                op = "add" if t in (_aten.sum.default, _aten.sum.dim_IntList) else (
                    "and" if "all" in str(t) else "or")
                r = x.refs[0]
                for s in x.refs[1:]:
                    r = b.emit(op, r, s)
                if op != "add" and len(x.refs) == 1 and self.env[args[0]].dtype != torch.bool:
                    r = b.emit("ne", r, b.const(0.0))
            return _Val(shape, [r])
        raise _Unsupported(f"the op {t} on the state's path")

    def logsumexp(self, refs):
        """aten's logsumexp: m = max with an infinite max set to 0, then
        log(sum exp(a - m)) + m; m carries no tangent."""
        b = self.b
        m = refs[0]
        for r in refs[1:]:
            m = b.emit("max_sg", m, r)
        m0 = b.emit("fin0", m) if m >= 0 else m
        s = None
        for r in refs:
            e = b.emit("exp", b.emit("sub", r, m0))
            s = e if s is None else b.emit("add", s, e)
        return b.emit("add", b.emit("log", s), m0)

    def elementwise_node(self, node, name, args, kw):
        t = node.target
        b = self.b
        A = self.arg
        if t in (_aten.add.Tensor, _aten.add.Scalar, _aten.sub.Tensor, _aten.sub.Scalar):
            x, y = A(args[0]), A(args[1])
            alpha = kw.get("alpha", 1)
            if alpha != 1:
                y = self.elementwise(node, "mul", [y, _Val((), [b.const(alpha)])])
            return self.elementwise(node, name, [x, y])
        if t in (_aten.rsub.Scalar, _aten.rsub.Tensor):
            x, y = A(args[0]), A(args[1])
            alpha = kw.get("alpha", 1)
            if alpha != 1:
                x = self.elementwise(node, "mul", [x, _Val((), [b.const(alpha)])])
            return self.elementwise(node, "sub", [y, x])
        if t in (_aten.div.Tensor, _aten.div.Scalar) and kw.get("rounding_mode") is not None:
            raise _Unsupported("a division with rounding")
        if t is _aten.softplus.default:
            beta = args[1] if len(args) > 1 else kw.get("beta", 1)
            thr = args[2] if len(args) > 2 else kw.get("threshold", 20)
            if beta != 1 or thr != 20:
                raise _Unsupported("softplus with beta != 1 or threshold != 20")
            return self.elementwise(node, name, [A(args[0])])
        if t is _aten.square.default:
            x = A(args[0])
            return self.elementwise(node, "mul", [x, x])
        if t is _aten.clamp.default:
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
            x = A(args[0])
            if lo is None and hi is None:
                return x
            if hi is None:
                return self.elementwise(node, "clamp_min", [x, A(lo)])
            if lo is None:
                return self.elementwise(node, "clamp_max", [x, A(hi)])
            if isinstance(lo, torch.fx.Node) or isinstance(hi, torch.fx.Node):
                raise _Unsupported("a clamp with tensor bounds")
            return self.elementwise(node, "clamp", [x, A(lo), A(hi)])
        arity = fd.OPS[name].arity
        return self.elementwise(node, name, [A(a) for a in args[:arity]])


class _Recorder(torch.fx.Interpreter):
    """Runs the trace once, keeping every node's value."""

    def __init__(self, gm):
        super().__init__(gm, garbage_collect_values=False)
        self.values = {}

    def run_node(self, n):
        out = super().run_node(n)
        self.values[n] = out
        return out


def _allocate(writer, out, n_in):
    """Dead instructions dropped, registers mapped to slots by liveness (an
    instruction's operands are read before its result is written, so the
    result may take a slot an operand frees). Returns (instructions with
    slots, the output's slot, the slot count)."""
    live, kept = {out}, []
    for ins in reversed(writer.ins):
        if ins[1] in live:
            kept.append(ins)
            live.update(a for a in ins[2:] if a is not None and a >= 0)
    kept.reverse()
    last = {}
    for i, ins in enumerate(kept):
        for a in ins[2:]:
            if a is not None and a >= 0:
                last[a] = i
    last[out] = len(kept)
    slot = {r: r for r in range(n_in)}
    free = []
    for r in range(n_in):
        if r not in last:
            heapq.heappush(free, r)
    n_slots = n_in
    prog = []
    for i, (name, dst, *opd) in enumerate(kept):
        for a in set(a for a in opd if a is not None and a >= 0):
            if last[a] == i:
                heapq.heappush(free, slot[a])
        if free:
            slot[dst] = heapq.heappop(free)
        else:
            slot[dst] = n_slots
            n_slots += 1
        prog.append((name, dst, slot[dst],
                     [None if a is None else (slot[a] if a >= 0 else a) for a in opd], opd))
    return prog, slot[out], n_slots


def _pe_split_admit(lp_fn, ex_shape, dtype, device, n_in, vector):
    """Trace `lp_fn` on v of shape `ex_shape`, split off what v does not
    reach, admit the rest and build its Tape; raises _Unsupported naming
    what declines."""
    from torch.fx.experimental.proxy_tensor import make_fx

    ex = torch.zeros(ex_shape, dtype=dtype, device=device)
    try:
        with fd.no_custom_rules():
            gm = make_fx(lp_fn)(ex)
        rec = _Recorder(gm)
        rec.run(ex)
    except _Unsupported:
        raise
    except Exception as e:  # a trace that fails (data-dependent control flow, ...)
        raise _Unsupported(f"a density that does not trace ({type(e).__name__}: {e})") from e
    vdep = set()
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            vdep.add(node)
        elif node.op == "call_function" and any(a in vdep for a in node.all_input_nodes):
            vdep.add(node)
    sc = _Scalarizer(gm, rec.values, vdep, n_in)
    # the input: the placeholder's elements are registers 0..n_in-1
    ph = next(n for n in gm.graph.nodes if n.op == "placeholder")
    sc.vals[ph] = _Val(tuple(ex_shape), list(range(n_in)))
    out = sc.run()
    if sc.value_ops > fd.VALUE_BUDGET or sc.deriv_ops > fd.DERIV_BUDGET:
        raise _Unsupported(
            f"a density of {sc.value_ops} operations ({sc.deriv_ops} with its derivative) "
            f"over the budgets {fd.VALUE_BUDGET} / {fd.DERIV_BUDGET}")
    b = sc.b
    prog, out_slot, n_slots = _allocate(b, out, n_in)
    if n_slots > fd.MAX_SLOTS or len(prog) > fd.MAX_TAPE:
        raise _Unsupported(f"a tape of {len(prog)} instructions in {n_slots} slots")
    words = [len(prog), n_slots, out_slot, n_in, int(vector), int(b.has_t[out])]
    for name, dst, dst_slot, opd, regs in prog:
        bits = TAN_OUT if b.has_t[dst] else 0
        for a, bit in zip(regs, (TAN_A, TAN_B, TAN_C)):
            if a is not None and a >= 0 and b.has_t[a]:
                bits |= bit
        words += [fd.OPS[name].code | bits, dst_slot, *[0 if a is None else a for a in opd]]
    return Tape(tuple(words), tuple(b.consts), n_in, vector, sc.value_ops, sc.deriv_ops)


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------


def _param_like(d):
    """A tensor parameter of `d` (the dtype and device of its trace)."""
    p = first_param(d)
    if p is None:
        raise _Unsupported(f"{type(d).__name__} with no tensor parameter")
    return p


def _admit(what, lp_fn, ex_shape, like, n_in, vector):
    try:
        return _pe_split_admit(lp_fn, ex_shape, like.dtype, like.device, n_in, vector)
    except _Unsupported as e:
        raise _Unsupported(f"{what} (traced: {e})") from e


def _traced_scalar_entry(d, link, n, row0):
    """The generic traced entry of a scalar (dist, link) leaf over n rows
    (an IID block): its linked density, the family's telescoped hook where
    it has one for this link (as `fused_traced.py:225-234` of the JAX
    package) else logpdf(x) + the inverse link's log-det, traced on a
    scalar v; every row runs the one tape. A leaf with per-element
    parameters traces to a density of shape (n,), not a scalar, and
    declines."""
    def lp1(v):
        hook = getattr(d, "fused_linked_logdensity", None)
        if hook is not None:
            out = hook(link, v, want_x=False)
            if out is not None:
                return out[1]
        x, ld = link.inverse_and_log_det(v)
        return d.logpdf(x) + ld

    what = f"{type(d).__name__} with link {type(link).__name__}"
    tape = _admit(what, lp1, (), _param_like(d), 1, False)
    return _Entry(row0, n, loop="traced", params=tape.params, k=n, tape=tape)


def _traced_vector_entry(leaf, row0):
    """The generic traced entry of a vector leaf of linked length L = 2-16
    (JointOrderStatistics' ordered link, ...): its whole linked density
    traced on the (L,) event, one scalar out. A batched-parameter leaf
    traces to a (G,) density and declines."""
    L = int(leaf.linked_vec_length)
    what = f"{type(leaf.dist).__name__} with link {type(leaf.link).__name__}"
    if L < 2 or L > 16:
        raise _Unsupported(f"{what} (linked length {L}: a traced vector entry takes 2-16)")

    def lp1(v):
        out = leaf.linked_logdensity(v)
        return out if out.ndim == 0 else out.reshape(())

    tape = _admit(what, lp1, (L,), _param_like(leaf.dist), L, True)
    return _Entry(row0, L, loop="traced", params=tape.params, k=L, tape=tape)
