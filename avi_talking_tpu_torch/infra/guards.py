"""NaN guards for losses, weights and pipeline stages (port of
``avi_talking_tpu/infra/guards.py``).

``check_loss`` and ``check_tree_finite`` are host checks that raise, as the
reference's manual guards do; ``guard_metrics`` replaces non-finite metrics
by -1 on the device. ``finite_or_debug`` prints when a stage's output goes
non-finite. ``checkify_step`` is the counterpart of JAX's
``checkify.checkify(fn, errors=float_checks)``: it watches the output of
every floating-point operation ``fn`` runs, not only what ``fn`` returns.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def check_loss(loss) -> None:
    """Raise on a NaN or infinite loss (a tensor on the card: one host sync)."""
    value = torch.as_tensor(loss)
    if not bool(torch.isfinite(value).all()):
        raise ValueError(f"NaN/inf loss: {loss}")


def _leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def check_tree_finite(tree: Any, name: str = "tree") -> None:
    """Raise when a floating tensor of ``tree`` (a module, a ``state_dict``,
    or nested mappings and sequences of tensors) holds a NaN or inf, naming
    the first ten such keys."""
    bad = [path for path, leaf in _leaves(tree)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise ValueError(f"non-finite leaves in {name}: {bad[:10]}")


def finite_or_debug(x: torch.Tensor, stage: str) -> torch.Tensor:
    """Print ``[nan-guard] non-finite output at stage <stage>`` when ``x``
    holds a NaN or inf; return ``x`` unchanged. The test is a host sync on
    the card (JAX's ``debug.print`` under ``cond`` is not), so it is a
    debugging aid, not something to leave in a hot loop."""
    if not bool(torch.isfinite(x).all()):
        print(f"[nan-guard] non-finite output at stage {stage}")
    return x


def guard_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Each non-finite tensor metric replaced by -1 (on its device); other
    values pass through."""
    return {k: torch.where(torch.isfinite(v), v, torch.full_like(v, -1.0))
            if isinstance(v, torch.Tensor) and v.is_floating_point() else v
            for k, v in metrics.items()}


class CheckError:
    """The outcome of a ``checkify_step`` call: ``error`` is None or the
    first failed check; ``throw()`` raises it."""

    def __init__(self, error: Optional[str] = None):
        self.error = error

    def get(self) -> Optional[str]:
        return self.error

    def throw(self) -> None:
        if self.error is not None:
            raise FloatingPointError(self.error)


_DIVISIONS = ("aten::div", "aten::remainder", "aten::fmod")


class _FloatChecks(TorchDispatchMode):
    """JAX's ``float_checks`` (``nan_checks | div_checks``) on every
    operator: records the first whose floating output holds a NaN, or the
    first division by a divisor holding a zero. Each check is a reduction
    and a host sync."""

    def __init__(self):
        super().__init__()
        self.error: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.error is None and func.name().startswith(_DIVISIONS) and len(args) > 1:
            divisor = torch.as_tensor(args[1])
            if bool((divisor == 0).any()):
                self.error = f"division by zero in {func}"
        out = func(*args, **(kwargs or {}))
        if self.error is None:
            for t in tree_flatten(out)[0]:
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    self.error = f"nan generated by {func}"
                    break
        return out


def checkify_step(fn: Callable) -> Callable[..., Tuple[CheckError, Any]]:
    """``fn`` -> a function returning ``(err, fn's output)``: ``err.throw()``
    raises ``FloatingPointError`` naming the first operator that produced a
    NaN or divided by zero. A debugging tool: every operator's
    output is tested, so the step runs many times slower."""

    def checked(*args, **kwargs):
        mode = _FloatChecks()
        with mode:
            out = fn(*args, **kwargs)
        return CheckError(mode.error), out

    return checked

