"""Where a gradient may pass, and where it must not pass silently.

The JAX package differentiates its steppers with ``jax.grad`` and
``jax.jvp`` (``tests/test_autodiff.py``).  In the port:

  * plain torch ops carry both modes: reverse mode (autograd) and forward
    mode (``torch.autograd.forward_ad``) through Euler and RK4 on the plain
    backend, forward mode through the semi-implicit CG and the RKM retry
    loop, and both through the semi-implicit step with
    ``SimParams.differentiable`` (``solvers/cg.cg_solve_diff``);
  * a hand-written kernel has no backward and no forward derivative, as
    the JAX package's Pallas kernels define no VJP: its output has no
    ``grad_fn`` and no tangent, so torch would go on with a partial
    gradient and raise nothing.  Every kernel wrapper therefore refuses an
    input that requires grad while grad mode is on, or that carries a
    tangent (``refuse_kernel``, from ``ops/cuda_launch.fields_ok``'s
    single pass);
  * the loops that the JAX package runs as ``lax.while_loop`` -- the CG
    solves and the RKM retry loop -- run on the host here, and autograd
    would record their iterations.  JAX refuses reverse mode through a
    ``while_loop``; so does the port (``refuse_reverse``).

Nothing here reads a value back from the device.
"""
from __future__ import annotations

import torch
from torch.autograd import forward_ad

from .state import Shards


class SilentGradientError(RuntimeError):
    """A gradient would have been dropped or taken another way than the
    JAX package takes it; the message names the way out."""


KERNEL_WAY_OUT = (
    "a CUDA kernel has no backward and no forward derivative, so its output would "
    "carry a partial gradient with no error. Run on the plain backend "
    "(backend = \"xla\" or \"torch\"), or, for the semi-implicit solver, with "
    "SimParams(differentiable=True) (adjoint CG solves on the kernels), or call it "
    "under torch.no_grad() outside forward mode")


def _tensors(fields):
    for f in fields:
        if isinstance(f, torch.Tensor):
            yield f
        elif isinstance(f, Shards):
            yield from f.blocks


def recording(*fields) -> bool:
    """Whether reverse mode records through ``fields`` (tensors,
    ``Shards``, or anything else, which is skipped): grad mode on and one
    of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(fields))


def carries_tangent(*fields) -> bool:
    """Whether one of ``fields`` carries a forward-mode tangent that the ops
    would propagate: inside a dual level with forward grad enabled (it is
    off inside an ``autograd.Function``'s forward)."""
    if forward_ad._current_level < 0 or not torch._C._is_fwd_grad_enabled():
        return False
    return any(forward_ad.unpack_dual(t).tangent is not None for t in _tensors(fields))


def refuse_kernel(tensors) -> None:
    """Raise ``SilentGradientError`` if one of the tensors a kernel would
    read requires grad under grad mode or carries a tangent."""
    if recording(*tensors) or carries_tangent(*tensors):
        raise SilentGradientError(f"a kernel wrapper was given an input that requires grad "
                                  f"or carries a tangent: {KERNEL_WAY_OUT}")


def refuse_reverse(what: str, way_out: str, *fields) -> None:
    """JAX's refusal of reverse mode through a ``lax.while_loop``, for the
    host loop ``what``: raise if reverse mode records through ``fields``."""
    if recording(*fields):
        raise SilentGradientError(
            f"reverse-mode differentiation through {what} is not supported, as JAX "
            f"refuses it for lax.while_loop: {way_out}")
