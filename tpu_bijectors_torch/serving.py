"""Serving export, PyTorch counterpart of `tpu_bijectors/serving.py`:
the density hot paths as serialized, shape-specialised `torch.export`
artifacts.

A server should not carry the model-building code or rebuild the model's
tables at start-up. `export_logdensity` and `export_constrain` trace the
density, its value and gradient, or the inverse link once, on a state of
one fixed batch, and serialize the `ExportedProgram` (`torch.export.save`)
to bytes. `load` gives back a callable that holds that contract: it raises
on a state of another shape, dtype or device.

On the card each kernel launch is recorded as its operator `tbt::<name>`
(`kernels.kernel_op`), with the model's tables (the slab's coefficients,
its run and item tables, the links' coefficient tables) as constants of
the artifact on the device they were made on. The artifact is not
self-contained as the JAX package's StableHLO is: loading it imports
`tpu_bijectors_torch.kernels`, which registers the operators, and the
first call builds the kernel library. On the CPU the plain versions are
traced as ordinary aten operators.

Export one artifact per supported batch size.
"""

from __future__ import annotations

import io

import torch


def _program(model, fn, batch_size: int, dtype, transposed: bool):
    """The `ExportedProgram` of `fn` on a (batch_size, dim) state
    ((dim, batch_size) when transposed) of `dtype` (default the model's)
    on the model's device.

    One call on a state of zeros comes first: it builds the model's tables
    (cached per model, dtype and device), so that the trace finds them as
    constants and makes none under its fake tensors. `make_fx` then traces
    `fn` on a fake state below autograd, the backward passes of a
    `value_and_grad_fn` included, into a graph of aten and `tbt::`
    operators; `torch.export` takes that graph. (`torch.export` alone
    cannot trace `torch.autograd.grad` through an operator that saves its
    output for the backward, such as `exp` or `tanh`: the saved output
    comes back as an untraced fake constant.)"""
    from torch.fx.experimental.proxy_tensor import make_fx

    dtype = dtype or model.dtype
    shape = (model.dim(), batch_size) if transposed else (batch_size, model.dim())
    example = torch.zeros(shape, dtype=dtype, device=model.device)
    fn(example)
    graph = make_fx(lambda v: fn(v), tracing_mode="fake", _allow_non_fake_inputs=True)(example)
    program = torch.export.export(graph, (example,), strict=False)
    program.example_inputs = None  # the artifact keeps no copy of the state of zeros
    return program


def _export(model, fn, batch_size: int, dtype, transposed: bool, path):
    """Serialize `_program`'s artifact to bytes, and write them to `path`
    if given."""
    buf = io.BytesIO()
    torch.export.save(_program(model, fn, batch_size, dtype, transposed), buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_logdensity(
    model,
    batch_size: int,
    with_grad: bool = False,
    transposed: bool = False,
    dtype=None,
    path: str | None = None,
) -> bytes:
    """Serialize the batched linked log-density logp(v): (B, dim) -> (B,),
    or on the transposed (dim, B) state the whole-model kernels read.

    with_grad=True exports v -> (logp, d sum(logp) / dv) instead, the
    density's `value_and_grad_fn`: what a leapfrog step consumes (on the
    transposed state #2's one pass). Returns the serialized bytes; also
    writes them to `path` if given."""
    fn = model.batched_logdensity_t_fn() if transposed else model.batched_logdensity_fn()
    if with_grad:
        fn = fn.value_and_grad_fn
    return _export(model, fn, batch_size, dtype, transposed, path)


def export_constrain(
    model,
    batch_size: int,
    dtype=None,
    path: str | None = None,
) -> bytes:
    """Serialize the inverse link v (B, dim) -> the constrained sample dict
    (the transform-serving path: flat draws in, native-support values
    out)."""
    return _export(model, model.constrain, batch_size, dtype, False, path)


def load(blob_or_path):
    """Deserialize an exported artifact (bytes, or a path) -> a callable
    with the frozen contract: it raises ValueError on a state of another
    shape, dtype or device. The callable's `exported_program` is the
    loaded `ExportedProgram`."""
    from . import kernels  # noqa: F401  (registers the tbt:: operators)

    src = blob_or_path
    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(bytes(src))
    program = torch.export.load(src)
    name = program.graph_signature.user_inputs[0]
    (spec,) = [n.meta["val"] for n in program.graph.nodes if n.name == name]
    module = program.module()

    def call(v):
        if v.shape != spec.shape or v.dtype != spec.dtype or v.device != spec.device:
            raise ValueError(
                f"the artifact takes a {tuple(spec.shape)} {spec.dtype} state on {spec.device}; "
                f"got {tuple(v.shape)} {v.dtype} on {v.device}")
        return module(v)

    call.exported_program = program
    return call
