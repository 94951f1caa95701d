"""AdamW whose update the card applies or skips, and gradient accumulation
decided on the card: no host sync in either.

Every task's optimizers (``train/tasks/``). optax's
``adamw`` rule, as torch's AdamW computes it (bias-corrected moments, eps
added to the root of the second moment, decoupled weight decay), with
three differences that let a CUDA graph capture the update:

- the moments live in one flat buffer per optimizer (``exp_avg`` and
  ``exp_avg_sq`` in ``state`` are views of it, so ``state_dict`` keeps
  torch's layout and torch's checkpoints load), and every parameter's
  ``step`` is the same device scalar, the optimizer's update count;
- ``update(lr, apply)`` takes the lr as a device tensor (a schedule read
  at ``count`` on the device) and a device bool ``apply``: where it is
  false the parameters, both moments and the count keep their bits
  exactly (``torch.where``, never a multiplication by 0, which NaN
  gradients would defeat);
- the state is allocated by ``init_state`` (the first update calls it),
  outside any capture, and never again unless a ``load_state_dict``
  replaces it. The lr of the last applied update is part of it: a float64
  device scalar that ``param_groups[0]["lr"]`` points to and each update
  overwrites in place, so a captured update never reads a tensor that a
  later assignment frees.

The update reads each parameter set once flattened (one ``torch.cat`` of
the parameters and one of the gradients) and writes it back with one
``_foreach_copy_``: about twenty launches for a set of any size.
"""

from __future__ import annotations

import torch


class MaskedAdamW(torch.optim.Optimizer):
    """AdamW over one parameter group; see the module docstring."""

    def __init__(self, params, lr: float, betas: tuple[float, float], eps: float, weight_decay: float):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        if len(self.param_groups) != 1:
            raise ValueError("MaskedAdamW takes one parameter group")
        self._flat = None  # (exp_avg, exp_avg_sq, count, lr) once the state exists

    @property
    def params(self) -> list:
        return self.param_groups[0]["params"]

    def _state_is_flat(self) -> bool:
        if self._flat is None:
            return False
        st = self.state.get(self.params[0], {})
        return st.get("exp_avg") is not None and st["exp_avg"].data_ptr() == self._flat[0].data_ptr()

    def init_state(self) -> None:
        """Allocate the flat moments and the count (zeros), or gather a
        loaded per-parameter state into them, and the lr buffer (the
        group's lr); a no-op when they exist."""
        if self._state_is_flat():
            return
        params = self.params
        sizes = [p.numel() for p in params]
        dev = params[0].device
        m = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
        v = torch.zeros_like(m)
        count = torch.zeros((), dtype=torch.float32, device=dev)
        lr = torch.empty((), dtype=torch.float64, device=dev)
        lr.copy_(torch.as_tensor(self.param_groups[0]["lr"], dtype=torch.float64))
        self.param_groups[0]["lr"] = lr
        first = self.state.get(params[0])
        if first:
            count.copy_(torch.as_tensor(first["step"], dtype=torch.float32))
        for p, mv, vv in zip(params, m.split(sizes), v.split(sizes)):
            st = self.state[p]
            if st:
                mv.copy_(st["exp_avg"].reshape(-1))
                vv.copy_(st["exp_avg_sq"].reshape(-1))
            st.update(step=count, exp_avg=mv.view_as(p), exp_avg_sq=vv.view_as(p))
        self._flat = (m, v, count, lr)

    @property
    def count(self) -> torch.Tensor | None:
        """The updates applied (a float32 device scalar), None before the
        first update."""
        return self._flat[2] if self._state_is_flat() else None

    def updates(self) -> int:
        """The updates applied (a host read of ``count``)."""
        return 0 if self.count is None else int(self.count)

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        self._flat = None
        if self.state:
            self.init_state()

    @torch.no_grad()
    def update(self, lr, apply: torch.Tensor | None = None) -> None:
        """One AdamW update of every parameter from its ``.grad`` at lr
        ``lr`` (a float64 device scalar, or a number); applied only where
        the device bool ``apply`` is true (None: always)."""
        self.init_state()
        m, v, count, lr_now = self._flat
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        params = self.params
        sizes = [p.numel() for p in params]
        p_old = torch.cat([p.detach().reshape(-1) for p in params])
        g = torch.cat([p.grad.reshape(-1) for p in params])
        lr = torch.as_tensor(lr, dtype=torch.float64, device=p_old.device)
        c = count.to(torch.float64) + 1.0
        step_size = (lr / (1.0 - torch.pow(b1, c))).to(torch.float32)
        bc2_sqrt = torch.sqrt(1.0 - torch.pow(b2, c)).to(torch.float32)
        m_new = torch.lerp(m, g, 1.0 - b1)
        v_new = v * b2 + g * g * (1.0 - b2)
        p_new = p_old * (1.0 - lr * wd).to(torch.float32) if wd else p_old
        p_new = p_new - step_size * m_new / (torch.sqrt(v_new) / bc2_sqrt + eps)
        if apply is None:
            m.copy_(m_new)
            v.copy_(v_new)
            count.add_(1.0)
            lr_now.copy_(lr)
        else:
            torch.where(apply, m_new, m, out=m)
            torch.where(apply, v_new, v, out=v)
            torch.where(apply, count + 1.0, count, out=count)
            torch.where(apply, lr, lr_now, out=lr_now)  # the last applied update's
            p_new = torch.where(apply, p_new, p_old)
        torch._foreach_copy_(params, [x.view_as(p) for x, p in zip(p_new.split(sizes), params)])


class GradAccumulator:
    """optax ``MultiSteps`` on the card, with the JAX tasks' skip: a running
    mean of k micro-steps' gradients and their count, both device tensors
    allocated once, so every micro-step runs the same captured graph.

    ``fold(finite)`` takes this micro-step's ``.grad`` of ``params``:
    ``mean += (g - mean) / (n + 1)`` (optax's Welford rule) and ``n += 1``,
    both only where the device bool ``finite`` is true (``torch.where``:
    the JAX task keeps MultiSteps' whole state on a non-finite step); then
    it puts the mean in ``.grad`` and returns ``apply = (n == k)``, the
    device bool of the update. ``reset(apply)`` zeroes the mean and the
    count where it is true. ``grads`` are per-parameter views of the mean,
    ``n`` is a float32 device scalar; both are in ``state_dict`` (a
    checkpoint's int ``n`` of the host rule loads too)."""

    def __init__(self, params, k: int):
        self.params = list(params)
        self.k = int(k)
        self.sizes = [p.numel() for p in self.params]
        dev = self.params[0].device
        self.mean = torch.zeros(sum(self.sizes), dtype=torch.float32, device=dev)
        self.grads = [v.view_as(p) for v, p in zip(self.mean.split(self.sizes), self.params)]
        self.n = torch.zeros((), dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fold(self, finite: torch.Tensor | None = None) -> torch.Tensor:
        """Fold the micro-step's gradients in (where ``finite``; None:
        always), leave the mean in ``.grad``; return the update's bool."""
        g = torch.cat([p.grad.reshape(-1) for p in self.params])
        mean = self.mean + (g - self.mean) / (self.n + 1.0)
        if finite is None:
            self.mean.copy_(mean)
            self.n.add_(1.0)
        else:
            torch.where(finite, mean, self.mean, out=self.mean)
            torch.where(finite, self.n + 1.0, self.n, out=self.n)
        torch._foreach_copy_([p.grad for p in self.params], self.grads)
        return self.n == self.k

    @torch.no_grad()
    def reset(self, apply: torch.Tensor) -> None:
        torch.where(apply, torch.zeros_like(self.mean), self.mean, out=self.mean)
        torch.where(apply, torch.zeros_like(self.n), self.n, out=self.n)

    def state_dict(self) -> dict:
        return {"grads": list(self.grads), "n": self.n}

    def load_state_dict(self, state: dict) -> None:
        for a, v in zip(self.grads, state["grads"], strict=True):
            a.copy_(v)
        self.n.copy_(torch.as_tensor(state["n"], dtype=torch.float32))
