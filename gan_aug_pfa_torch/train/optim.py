"""Optimizers with the JAX package's semantics (``train/optim.py``).

  adamw: decoupled weight decay, ``torch.optim.AdamW`` (optax.adamw).
  adam:  ``torch.optim.Adam``, whose weight_decay adds wd*param to the
         gradient before the moment update (coupled L2), as the JAX
         package's ``add_decayed_weights`` before ``scale_by_adam``.

Betas (0.9, 0.999) and eps 1e-8 in both.  The learning rate lives in the
optimizer's ``param_groups``: ``set_learning_rate`` rewrites it between
epochs.

The JAX package's three optimizer knobs have no counterpart in
``torch.optim``; with any of them ``make_optimizer`` returns
``OptaxAdam``, an Adam(W) step written out in optax's arithmetic:

  * ``mu_dtype="bfloat16"`` (``--momentum-dtype``): the first moment is
    stored in bfloat16.  As optax's ``scale_by_adam``, the new moment
    ``(1-b1) g + b1 mu`` is computed in float32 and used in that precision
    for the update; only then is it stored, rounded to bfloat16.
    ``"float32"`` is the default optimizer.
  * ``flat=True`` (``--flat-opt-state``, ``optax.flatten``): the moments
    are two 1-D buffers, and the parameters become views of one flat
    buffer, so that the update runs over one tensor; the model's
    ``state_dict`` keys are unchanged.  Under the tensor-parallel 'model'
    axis (``parallel/tensor.py``) the buffer and the moments hold this
    rank's parameters as they are, the blocks of the sharded ones: per-rank
    blocks, not JAX's whole flat moments (whose odd lengths its rule
    replicates).  The update is elementwise, so it is one process's; the
    checkpoint layer re-lays the moments as the whole parameters' vector
    when it saves and cuts them when it restores.
  * ``grad_accum=k`` (``--grad-accum``, ``optax.MultiSteps``): each
    ``step`` folds the gradients into a running mean,
    ``acc + (g - acc)/(n + 1)`` with ``n`` the mini-step; the k-th applies
    one Adam(W) step to the mean and clears it, the others leave the
    parameters untouched.  ``mini_step`` and the Adam count live in the
    optimizer's state, so they carry across epochs and resumes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

MOMENTUM_DTYPES = ("bfloat16", "float32")


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   learning_rate: float, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   mu_dtype: Optional[str] = None, flat_state: bool = False,
                   grad_accum: int = 1) -> torch.optim.Optimizer:
    """``torch.optim.AdamW``/``Adam`` without a knob (``mu_dtype`` None or
    "float32", ``flat_state`` False, ``grad_accum`` <= 1, which the JAX
    package reads as no accumulation), else
    ``OptaxAdam``.  Build it after the model has its device and dtype:
    ``flat_state`` makes the parameters views of one buffer."""
    name = name.lower()
    if name not in ("adamw", "adam"):
        raise ValueError(f"Unknown optimizer: {name}")
    if mu_dtype not in (None,) + MOMENTUM_DTYPES:
        raise ValueError(f"mu_dtype must be one of {MOMENTUM_DTYPES}, got "
                         f"{mu_dtype!r}")
    if mu_dtype == "bfloat16" or flat_state or grad_accum > 1:
        return OptaxAdam(params, learning_rate, weight_decay, (b1, b2), eps,
                         decoupled=name == "adamw", mu_dtype=mu_dtype,
                         flat=flat_state, grad_accum=grad_accum)
    cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
    return cls(params, lr=learning_rate, betas=(b1, b2), eps=eps,
               weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class LayoutMismatchError(ValueError):
    """An optimizer state whose layout is not this optimizer's."""


def layout_name(mu_dtype: str = "float32", flat: bool = False,
                multi_steps: bool = False) -> str:
    """How the CLIs name an optimizer-state layout, by the flags that
    give it."""
    knobs = [text for on, text in (
        (multi_steps, "optax.MultiSteps (--grad-accum > 1)"),
        (flat, "flattened (--flat-opt-state)"),
        (mu_dtype == "bfloat16",
         "bfloat16 first moments (--momentum-dtype bfloat16)")) if on]
    return ", ".join(knobs) or "per-parameter float32 moments (no knob)"


# The layout of torch.optim's Adam and AdamW states.
DEFAULT_LAYOUT = {"mu_dtype": "float32", "flat": False, "multi_steps": False}


def layout_of(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The state layout of ``optimizer``: {"mu_dtype", "flat",
    "multi_steps"}."""
    if isinstance(optimizer, OptaxAdam):
        return optimizer.layout()
    return dict(DEFAULT_LAYOUT)


def check_layout(optimizer: torch.optim.Optimizer,
                 saved: Dict[str, Any]) -> None:
    """Raise ``LayoutMismatchError``, naming both layouts, unless a state
    of layout ``saved`` fits ``optimizer``."""
    saved = {k: saved[k] for k in DEFAULT_LAYOUT}
    mine = layout_of(optimizer)
    if saved != mine:
        raise LayoutMismatchError(
            f"the optimizer state is {layout_name(**saved)}; this run's "
            f"flags give {layout_name(**mine)}")


def saved_layout(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """The layout of an optimizer ``state_dict``: an ``OptaxAdam``'s
    names it, torch.optim's has the default."""
    return state_dict.get("layout", DEFAULT_LAYOUT)


def _fma(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a x + y`` rounded once to ``x``'s dtype, the fused multiply-add
    that XLA forms for optax's moment and weight-decay sums: the product
    is exact in float64 for float32 operands, and so is the sum but for
    a rare double rounding."""
    t = x.to(torch.float64) * a  # a new tensor: x may be float64 already
    return t.add_(y.to(torch.float64)).to(x.dtype)


class OptaxAdam(torch.optim.Optimizer):
    """Adam (``decoupled=False``: coupled L2, torch's Adam) or AdamW in
    optax's arithmetic with the JAX package's knobs (module docstring).
    One parameter group; its "lr" and "weight_decay" are read at every
    step, as optax's injected hyperparameters are.

    A parameter without a gradient takes a zero one, as optax's gradient
    trees hold one for every parameter."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 decoupled: bool = True, mu_dtype: Optional[str] = None,
                 flat: bool = False, grad_accum: int = 1):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      betas=tuple(betas), eps=eps))
        if len(self.param_groups) != 1:
            raise ValueError("OptaxAdam takes one parameter group")
        self.decoupled = decoupled
        self.mu_dtype = mu_dtype or "float32"
        self.flat = flat
        self.grad_accum = int(grad_accum)
        self.count = 0          # optax's count: Adam steps applied
        self.mini_step = 0      # MultiSteps counters
        self.gradient_step = 0
        ps = self._params()
        self.flat_param = _flatten_params(ps) if flat else None
        like = [self.flat_param] if flat else ps
        self.exp_avg = [torch.zeros_like(
            p, dtype=torch.bfloat16 if self.mu_dtype == "bfloat16" else None)
            for p in like]
        self.exp_avg_sq = [torch.zeros_like(p) for p in like]
        self.acc = ([torch.zeros_like(p) for p in like]
                    if self.grad_accum > 1 else None)

    def _params(self) -> List[torch.Tensor]:
        return self.param_groups[0]["params"]

    def layout(self) -> Dict[str, Any]:
        return {"mu_dtype": self.mu_dtype, "flat": self.flat,
                "multi_steps": self.grad_accum > 1}

    def _grads(self) -> List[torch.Tensor]:
        ps = self._params()
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in ps]
        if self.flat:
            return [torch.cat([g.reshape(-1) for g in gs])]
        return gs

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads = self._grads()
        if self.acc is not None:
            # optax.MultiSteps: the running mean, then an Adam step on the
            # k-th mini-step only.
            n = self.mini_step
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, n + 1)
            torch._foreach_add_(self.acc, diff)
            emit = n == self.grad_accum - 1
            self.mini_step = (n + 1) % self.grad_accum
            if not emit:
                return loss
            self.gradient_step += 1
            grads = self.acc
        self._adam(grads)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return loss

    def _adam(self, grads: List[torch.Tensor]) -> None:
        """One optax Adam(W) step (``scale_by_adam``, then
        ``add_decayed_weights`` for AdamW, then ``-lr``; Adam adds the
        decay to the gradient first).  The constants are rounded as JAX
        rounds them: optax.adamw injects b1 and b2 as arrays of the
        parameters' dtype, the JAX package's Adam chain closes over them
        as Python floats, which a bfloat16 moment rounds to bfloat16."""
        group = self.param_groups[0]
        lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
        b1, b2 = group["betas"]
        params = [self.flat_param] if self.flat else self._params()
        dt = params[0].dtype

        def rnd(x, dtype=dt):
            return float(torch.tensor(x, dtype=dtype))

        bf16 = self.mu_dtype == "bfloat16"
        if self.decoupled:
            b1, b2 = rnd(b1), rnd(b2)
            c1, c2, b1_mu = rnd(1.0 - b1), rnd(1.0 - b2), b1
        else:
            c1, c2 = rnd(1.0 - b1), rnd(1.0 - b2)
            b1_mu = rnd(rnd(b1, torch.bfloat16) if bf16 else b1)
            b1, b2 = rnd(b1), rnd(b2)
        self.count += 1
        bc1 = rnd(1.0 - rnd(b1 ** self.count))
        bc2 = rnd(1.0 - rnd(b2 ** self.count))
        # Multi-tensor ops over the parameter lists (one tensor when flat):
        # a few launches an op, as torch's foreach Adam(W).
        mu, nu = self.exp_avg, self.exp_avg_sq
        if not self.decoupled:
            grads = ([_fma(rnd(wd), p, g) for p, g in zip(params, grads)]
                     if bf16 else torch._foreach_add(grads, params, alpha=wd))
        if bf16:
            m = [_fma(c1, g, v.float().mul_(b1_mu)) for g, v in zip(grads, mu)]
            for v, new in zip(mu, m):
                v.copy_(new)
        else:
            torch._foreach_mul_(mu, b1_mu)
            torch._foreach_add_(mu, grads, alpha=c1)
            m = mu
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=c2)
        u = torch._foreach_div(m, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(u, denom)
        if self.decoupled:
            torch._foreach_add_(u, params, alpha=wd)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(params, u)

    # -- state ---------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        group = {k: v for k, v in self.param_groups[0].items()
                 if k != "params"}
        group["params"] = list(range(len(self._params())))
        return {"layout": dict(self.layout(), grad_accum=self.grad_accum),
                "param_groups": [group], "count": self.count,
                "mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "exp_avg": list(self.exp_avg),
                "exp_avg_sq": list(self.exp_avg_sq),
                "acc": None if self.acc is None else list(self.acc)}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Load a ``state_dict`` of an ``OptaxAdam`` of the same layout
        (``LayoutMismatchError`` otherwise; a different ``grad_accum``
        is taken, as the JAX package takes a MultiSteps state under
        another k)."""
        check_layout(self, saved_layout(state_dict))
        group = self.param_groups[0]
        for k, v in state_dict["param_groups"][0].items():
            if k != "params":
                group[k] = tuple(v) if k == "betas" else v
        self.count = int(state_dict["count"])
        self.mini_step = int(state_dict["mini_step"])
        self.gradient_step = int(state_dict["gradient_step"])
        keys = ("exp_avg", "exp_avg_sq") + (("acc",) if self.acc else ())
        for key in keys:
            mine, theirs = getattr(self, key), state_dict[key]
            if len(mine) != len(theirs):
                raise ValueError(f"{key}: {len(theirs)} tensors for "
                                 f"{len(mine)}")
            for t, v in zip(mine, theirs):
                if t.shape != v.shape:
                    raise ValueError(f"{key}: shape {tuple(v.shape)} for "
                                     f"{tuple(t.shape)}")
                t.copy_(v)


def _flatten_params(params: List[torch.Tensor]) -> torch.Tensor:
    """One buffer holding every parameter, each parameter made a view of
    its slice (in order); returns the buffer."""
    p0 = params[0]
    if any(p.dtype != p0.dtype or p.device != p0.device for p in params):
        raise ValueError("flat_state needs one dtype and one device")
    flat = torch.empty(sum(p.numel() for p in params), dtype=p0.dtype,
                       device=p0.device)
    off = 0
    with torch.no_grad():
        for p in params:
            view = flat[off:off + p.numel()].view_as(p)
            view.copy_(p)
            p.data = view
            off += p.numel()
    return flat
