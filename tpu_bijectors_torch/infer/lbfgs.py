# Portions of this file are adapted from optax 0.2.6
# (optax/_src/alias.py `lbfgs`, optax/_src/transform.py `scale_by_lbfgs`,
# optax/_src/linesearch.py `zoom_linesearch`, `scale_by_zoom_linesearch`):
#
# Copyright 2019-2024 DeepMind Technologies Limited. All Rights Reserved.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
"""L-BFGS with a zoom line search: the port of `optax.lbfgs()` as the JAX
package's `fit_map` and `fit_pathfinder` call it (memory 10, a scaled
identity as the first preconditioner, the zoom line search at 20 steps
with an initial step of one).

Each step preconditions the gradient by the two-loop recursion over the
last `memory_size` (s, y) pairs (Nocedal & Wright, Algorithms 7.4-7.5),
on the device, and searches along the negated direction for a step with
sufficient decrease and small curvature (Algorithms 3.5-3.6, with Hager &
Zhang's approximate decrease test near a minimum), taking the cubic or
quadratic interpolant's minimiser inside the bracket, else its midpoint.
The line search is a host loop: each trial evaluates the loss and its
gradient once and reads the value and the slope along the direction to
the host once (`hmc_batched.SYNCS['linesearch']`); the first trial's read
carries the initial slope (and, where the step starts without a cached
value, the value) with it. The accepted trial's value and gradient start
the next step, as `optax.value_and_grad_from_state` reuses them, so a
step costs exactly its trials' evaluations. The scalar logic runs in numpy
scalars of the iterate's dtype, as optax's runs in its arrays' dtype.

The run takes a fixed number of steps, as the JAX package's scan does;
past convergence a step's direction is zero and its first trial passes,
so the iterate stays put and finite (a zero gradient scales the first
preconditioner by one, never by 1/0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hmc_batched import SYNCS

# optax.lbfgs()'s settings: scale_by_lbfgs(memory_size=10,
# scale_init_precond=True) and scale_by_zoom_linesearch(
# max_linesearch_steps=20, initial_guess_strategy='one') at its defaults
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0

_NP = {torch.float64: np.float64, torch.float32: np.float32, torch.float16: np.float16}


class LbfgsTrace(NamedTuple):
    """A run's record: the iterate, loss and gradient at the start of each
    step (n_steps, ...), the iterate after the last step, and each step's
    loss evaluations and line-search trials (host lists)."""

    positions: torch.Tensor
    values: torch.Tensor
    grads: torch.Tensor
    final: torch.Tensor
    evals: list
    linesearch_steps: list


def _stack(ts, like):
    """torch.stack of a run's records; an empty run gives (0,) + like's shape."""
    return torch.stack(ts) if ts else like.new_empty((0,) + like.shape)


def _read(tensors):
    """One device -> host read of 0-d tensors, counted."""
    SYNCS["linesearch"] += 1
    return torch.stack(tensors).tolist()


class _Memory:
    """scale_by_lbfgs's state on the device: the last `m` parameter and
    gradient differences (rows at count % m), their weights 1 / <du, dw>,
    and the previous iterate and gradient."""

    def __init__(self, v0, m):
        self.m, self.count = m, 0
        self.dw = v0.new_zeros((m,) + v0.shape)
        self.du = v0.new_zeros((m,) + v0.shape)
        self.rho = v0.new_zeros((m,))
        self.params, self.updates = torch.zeros_like(v0), torch.zeros_like(v0)

    def direction(self, grad, params):
        """The preconditioned gradient P_k g_k (optax's update_fn): store
        the newest pair, then the two-loop recursion."""
        m = self.m
        idx, prev = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dp, du = params - self.params, grad - self.updates
            vd = torch.dot(du, dp)
            w = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            num, den = torch.dot(du, dp), torch.dot(du, du)
            scale = torch.where(den > 0.0, num / den, torch.ones_like(den))
        else:
            dp, du, w = torch.zeros_like(params), torch.zeros_like(grad), grad.new_zeros(())
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        self.dw[prev], self.du[prev], self.rho[prev] = dp, du, w
        # oldest to newest; the slots never written hold zero weights, which
        # leave the vector as it is, so only the filled ones are walked
        order = [(idx + i) % m for i in range(m)][m - min(self.count, m):]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * torch.dot(self.dw[i], vec)
            vec = vec - alphas[i] * self.du[i]
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * torch.dot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.count += 1
        self.params, self.updates = params, grad
        return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (optax `_cubicmin`); NaN where none is real."""
    F = type(a)
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    x0, x1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * x0 + (-(db * db)) * x1) / denom
    B = ((-(dc * dc * dc)) * x0 + db * db * db * x1) / denom
    return a + (-B + np.sqrt(B * B - F(3.0) * A * C)) / (F(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax `_quadmin`)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (type(a)(2.0) * B)


class _Zoom:
    """zoom_linesearch's state and its two phases on host scalars of type
    F; the gradients stay on the device."""

    def __init__(self, F, value, grad, slope):
        self.F = F
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = F(0.0), value, grad, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = F(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = F(0.0), value, slope
        self.high, self.value_high, self.slope_high = F(0.0), value, slope
        self.cubic_ref, self.value_cubic_ref = F(0.0), value
        self.safe_stepsize, self.safe_value, self.safe_grad = F(0.0), value, grad

    def _errors(self, stepsize, value, slope):
        F = self.F
        dec = value - self.value_init - F(SLOPE_RTOL) * stepsize * self.slope_init
        approx = slope - F(2 * SLOPE_RTOL - 1.0) * self.slope_init
        delta = value - self.value_init - F(APPROX_DEC_RTOL) * abs(self.value_init)
        dec = np.minimum(np.maximum(approx, delta), dec)
        dec = np.maximum(dec, F(0.0))
        dec = F(np.inf) if np.isnan(dec) else dec
        curv = np.maximum(abs(slope) - F(CURV_RTOL) * abs(self.slope_init), F(0.0))
        curv = F(np.inf) if np.isnan(curv) else curv
        return dec, curv

    def next_stepsize(self):
        """The stepsize the next trial evaluates."""
        F = self.F
        if not self.interval_found:
            return F(1.0) if self.count == 0 else F(INCREASE_FACTOR) * self.stepsize
        low, high = self.low, self.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic = _cubicmin(low, self.value_low, self.slope_low, high, self.value_high,
                          self.cubic_ref, self.value_cubic_ref)
        if (cubic > left + F(0.2) * delta) and (cubic < right - F(0.2) * delta):
            return cubic
        quad = _quadmin(low, self.value_low, self.slope_low, high, self.value_high)
        if (quad > left + F(0.1) * delta) and (quad < right - F(0.1) * delta):
            return quad
        return (low + high) / F(2.0)

    def search(self, new, value, grad, slope):
        """_search_interval given the trial (new, value, grad, slope)."""
        dec, curv = self._errors(new, value, slope)
        err = max(dec, curv)
        if dec <= 0.0:
            self.safe_stepsize, self.safe_value, self.safe_grad = new, value, grad
        high_new = (dec > 0.0) or ((value >= self.value) and self.count > 0)
        low_new = (slope >= 0.0) and not high_new
        prev = (self.stepsize, self.value, self.slope)
        cur = (new, value, slope)
        lo, hi = (cur, prev) if low_new else (prev, cur)
        self.low, self.value_low, self.slope_low = lo
        self.high, self.value_high, self.slope_high = hi
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.interval_found = high_new or low_new or err <= 0.0
        self.done = err <= 0.0
        self.failed = (self.count + 1 >= MAX_LINESEARCH_STEPS) and not self.done
        self._take(new, value, grad, slope, dec)

    def zoom(self, middle, value, grad, slope):
        """_zoom_into_interval given the trial at `middle`."""
        too_small = abs(self.high - self.low) <= STEPSIZE_PRECISION
        dec, curv = self._errors(middle, value, slope)
        err = max(dec, curv)
        if dec <= 0.0 and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = middle, value, grad
        self.done = err <= 0.0
        high_mid = (dec > 0.0) or (value >= self.value_low)
        high_low = (slope * (self.high - self.low) >= 0.0) and not high_mid
        lo = (self.low, self.value_low, self.slope_low)
        hi = (self.high, self.value_high, self.slope_high)
        mid = (middle, value, slope)
        new_hi = lo if high_low else (mid if high_mid else hi)
        new_lo = lo if high_mid else mid
        self.cubic_ref, self.value_cubic_ref = hi[:2] if (high_mid or high_low) else lo[:2]
        self.low, self.value_low, self.slope_low = new_lo
        self.high, self.value_high, self.slope_high = new_hi
        reached = (self.count + 1) >= MAX_LINESEARCH_STEPS
        self.failed = (reached or (too_small and self.safe_stepsize > 0.0)) and not self.done
        self._take(middle, value, grad, slope, dec)

    def _take(self, stepsize, value, grad, slope, dec):
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = stepsize, value, grad, slope
        self.decrease_error = dec
        if self.failed and (self.safe_stepsize > 0.0 or np.isinf(dec)):
            # _try_safe_step: a stepsize with sufficient decrease, or none
            self.stepsize, self.value, self.grad = (
                self.safe_stepsize, self.safe_value, self.safe_grad)


def lbfgs(value_and_grad, v0, n_steps: int, memory_size: int = MEMORY_SIZE) -> LbfgsTrace:
    """Minimise a loss from v0 (dim,) for `n_steps` L-BFGS steps.
    `value_and_grad(v)` returns (loss 0-d, gradient (dim,)) on v's device."""
    F = _NP[v0.dtype]
    mem = _Memory(v0, memory_size)
    v, value, value_t, grad = v0, F(np.inf), None, None
    positions, values, grads, evals, ls_steps = [], [], [], [], []
    with np.errstate(all="ignore"):
        for _ in range(n_steps):
            n_eval, pending = 0, []
            if not np.isfinite(value):
                # value_and_grad_from_state: no cached value, evaluate here;
                # the value is read with the first trial's
                value_t, grad = value_and_grad(v)
                n_eval, pending = 1, [value_t]
            u = -mem.direction(grad, v)
            # the first trial, at stepsize 1, needs nothing from the host
            x_t, gx = value_and_grad(v + u)
            got = _read(pending + [torch.dot(u, grad), x_t, torch.dot(gx, u)])
            if pending:
                value = F(got[0])
            slope0, val, slope = (F(t) for t in got[-3:])
            ls = _Zoom(F, value, grad, slope0)
            ls.search(F(1.0), val, gx, slope)
            n_eval += 1
            while not (ls.done or ls.failed):
                step = ls.next_stepsize()
                x_t, gx = value_and_grad(v + float(step) * u)
                val, slope = (F(t) for t in _read([x_t, torch.dot(gx, u)]))
                (ls.zoom if ls.interval_found else ls.search)(step, val, gx, slope)
                n_eval += 1
            positions.append(v)
            values.append(value)
            grads.append(grad)
            evals.append(n_eval)
            ls_steps.append(ls.count)
            v = v + float(ls.stepsize) * u
            value, grad = ls.value, ls.grad
    return LbfgsTrace(
        _stack(positions, v0),
        torch.tensor(np.asarray(values, dtype=F), dtype=v0.dtype, device=v0.device),
        _stack(grads, v0), v, evals, ls_steps,
    )
