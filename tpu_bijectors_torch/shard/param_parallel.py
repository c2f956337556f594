"""Parameter-dimension sharding over `torch.distributed`, PyTorch
counterpart of `tpu_bijectors/shard/param_parallel.py`: the flat
unconstrained vector cut across the ranks of a mesh dim, each rank running
the links and densities of its own slice, and only the density crossing
between ranks. Two cases:

* homogeneous IID blocks (thousands to millions of coefficients of one
  family): each rank holds an equal slice of the blocks, runs the block
  bijector on it, and one `all_reduce` sums the (B,) log-det or
  log-density;
* heterogeneous products (`TreeUnconstrainer`, the reference's `Stacked`
  block ranges): whole child blocks are assigned to ranks by a balanced
  contiguous partition (`ParamLayout`), the ranks' segments zero-padded to
  a common length; each rank evaluates only its children's linked
  densities on its segment, and one `all_reduce` of the (B,) density
  reassembles the model's.

As in `chain_parallel.py`, a rank passes its own slice (`shard_params`, of
the packed layout for a tree) and gets its own results back. The sum
across ranks passes the gradient of the replicated density straight back
to each rank's slice (`_SumOverRanks`), so a leapfrog differentiates it.
Chains remain the first axis to shard for small models; both together make
a 2-D ("chain", "param") mesh, each rank holding a block of chains of its
parameter slice.
"""

from __future__ import annotations

import dataclasses as _dataclasses

import torch

from ..dists.base import first_param
from ..infer.adapt import group_size, psum
from ..vectorize.core import IIDUnconstrainer, TreeUnconstrainer, Unconstrainer, unconstrain


class _SumOverRanks(torch.autograd.Function):
    """The sum of x over the ranks of `group`; its backward hands each rank
    the cotangent of the (replicated) sum unchanged, the derivative of the
    sum in this rank's own term."""

    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def shard_params(mesh, v, axis_name: str = "param"):
    """This rank's slice of a (..., dim) flat vector: the last axis cut
    into equal contiguous slices over the mesh dim, in rank order."""
    n_dev = group_size(mesh.get_group(axis_name))
    if v.shape[-1] % n_dev:
        raise ValueError(f"dim {v.shape[-1]} not divisible by mesh size {n_dev}")
    n = v.shape[-1] // n_dev
    r = mesh.get_local_rank(axis_name)
    return v[..., r * n:(r + 1) * n].contiguous()


def _check_iid(u: Unconstrainer, n_dev: int) -> IIDUnconstrainer:
    if not isinstance(u, IIDUnconstrainer):
        raise ValueError(
            "param-parallel sharding needs a homogeneous IID block "
            "(IIDUnconstrainer) or a heterogeneous product "
            f"(TreeUnconstrainer), got {type(u).__name__}; shard chains instead"
        )
    if u.n % n_dev:
        raise ValueError(f"block count {u.n} not divisible by mesh size {n_dev}")
    return u


@_dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Static rank layout for heterogeneous parameter sharding.

    `assign[i]` is the tuple of child indices rank i owns (a balanced
    contiguous partition of the TreeUnconstrainer's children: block order
    is kept, so packing gathers contiguous slices of v); `seg_len` is the
    common segment length (the longest owned length, zero-padded).
    `pack(v)` maps the model's flat (..., dim) vector to the padded
    (..., n_dev * seg_len) layout that `shard_params` slices."""

    child_ranges: tuple  # (start, len) per child in linked-vec space
    assign: tuple  # per rank: tuple of child indices
    seg_len: int

    @property
    def n_dev(self):
        return len(self.assign)

    @property
    def packed_dim(self):
        return self.n_dev * self.seg_len

    def pack(self, v):
        segs = []
        for owned in self.assign:
            parts = [v[..., s:s + l] for s, l in (self.child_ranges[c] for c in owned)]
            seg = torch.cat(parts, dim=-1) if parts else v.new_zeros(v.shape[:-1] + (0,))
            pad = self.seg_len - seg.shape[-1]
            if pad:
                seg = torch.cat([seg, v.new_zeros(v.shape[:-1] + (pad,))], dim=-1)
            segs.append(seg)
        return torch.cat(segs, dim=-1)


def build_param_layout(u: TreeUnconstrainer, n_dev: int) -> ParamLayout:
    """Balanced contiguous partition of the children over n_dev ranks:
    walk the blocks in order, starting a new rank whenever the running
    segment would exceed the ideal share (whole blocks only: an entangled
    block such as a simplex or an LKJ triangle never straddles ranks, so
    every link runs rank-local)."""
    lens = [l for _, l in u.linked_offsets]
    ideal = sum(lens) / n_dev
    assign, cur, cur_len, used = [], [], 0, 0
    for i, li in enumerate(lens):
        if cur and cur_len + li > ideal and len(assign) < n_dev - 1:
            assign.append(tuple(cur))
            cur, cur_len = [], 0
        cur.append(i)
        cur_len += li
        used = max(used, cur_len)
    assign.append(tuple(cur))
    while len(assign) < n_dev:
        assign.append(())
    return ParamLayout(tuple(u.linked_offsets), tuple(assign), used)


def param_parallel_from_linked(u: Unconstrainer, mesh, axis_name: str = "param"):
    """`from_linked_vec` with the parameter axis sharded: fn(v) -> (x,
    logdet) on this rank's slice v (..., dim / n_ranks) of an IID block,
    x this rank's blocks, logdet summed over the ranks (the same on
    every rank)."""
    group = mesh.get_group(axis_name)
    u = _check_iid(u, group_size(group))
    local = IIDUnconstrainer(u.inner, u.n // group_size(group))

    def fn(v):
        x, ld = local.from_linked_vec(v)
        return x, _SumOverRanks.apply(ld, group)

    return fn


def param_parallel_logdensity(d_or_u, mesh, axis_name: str = "param",
                              batch_axis_name: str = None):
    """The sharded linked log-density: fn(v) -> logpdf(x) + logdet (B,)
    on this rank's slice v, one `all_reduce` across the ranks of the mesh
    dim `axis_name`. An IID block takes the slices of the model's own
    (..., dim) layout; a heterogeneous product (TreeUnconstrainer) takes
    them of the padded layout: fn carries `fn.layout` (a ParamLayout), and
    `shard_params(mesh, fn.layout.pack(v))` is this rank's slice.

    `batch_axis_name` names the other dim of a 2-D ("chain", "param")
    mesh, whose ranks hold different rows of the leading batch axis: the
    sum still crosses `axis_name`'s ranks alone, so chain rows stay
    independent."""
    if not isinstance(d_or_u, Unconstrainer):
        p = first_param(d_or_u)  # a distribution's unconstrainer stays on its device
        d_or_u = unconstrain(d_or_u, device=None if p is None else p.device)
    u = d_or_u
    if batch_axis_name is not None and batch_axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no dim {batch_axis_name!r}")
    group = mesh.get_group(axis_name)
    n_dev = group_size(group)
    if isinstance(u, TreeUnconstrainer):
        return _tree_param_parallel_logdensity(u, mesh, axis_name, batch_axis_name, n_dev)
    u = _check_iid(u, n_dev)
    local = IIDUnconstrainer(u.inner, u.n // n_dev)

    def fn(v):
        return _SumOverRanks.apply(local.from_linked_vec_with_logpdf(v)[1], group)

    return fn


def _tree_param_parallel_logdensity(u: TreeUnconstrainer, mesh, axis_name: str = "param",
                                    batch_axis_name: str = None, n_dev: int = None):
    """Heterogeneous parameter sharding: this rank runs only its own
    children's links and densities on its padded segment (at the offsets
    the contiguous packing gives them), and one `all_reduce` sums
    sum_i [logpdf_i + logdet_i] over the ranks."""
    group = mesh.get_group(axis_name)
    layout = build_param_layout(u, n_dev or group_size(group))
    owned = layout.assign[mesh.get_local_rank(axis_name)]

    def fn(v):
        acc = v[..., :0].sum(-1)  # zeros that carry v's graph: a rank may own nothing
        o = 0
        for c in owned:
            _, l = u.linked_offsets[c]
            acc = acc + u.children[c].linked_logdensity(v[..., o:o + l])
            o += l
        return _SumOverRanks.apply(acc, group)

    fn.layout = layout
    return fn

