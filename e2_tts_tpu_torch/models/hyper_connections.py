"""Hyper-connections (arXiv 2409.19606; counterpart of
e2_tts_tpu/models/hyper_connections.py).

Each residual branch reads a learned mixture of N residual streams (width
connection, kernels K5/K3) and writes back through learned per-stream gains
(depth connection), with tanh-bounded dynamic corrections on top of static
weights. Streams are an explicit leading axis ``(s, b, n, d)``.

The depth connection is left lazy (`LazyStreams`): the next
`HyperConnection` in a chain hands ``carried``, ``branch`` and ``beta`` to
K3, which forms ``carried + branch * beta`` in registers; `materialize()`
writes the streams out only at chain breaks (cross-condition, UNet skips,
the end of a layer).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck


class LazyStreams(NamedTuple):
    """Residual streams left as (carried, branch, beta)."""

    carried: torch.Tensor   # (s, b, n, d)
    branch: torch.Tensor    # (b, n, d)
    beta: torch.Tensor      # (s, b, n)

    @property
    def dtype(self):
        return self.carried.dtype

    @property
    def shape(self):
        return self.carried.shape

    def materialize(self) -> torch.Tensor:
        dt = self.carried.dtype
        return self.carried + self.branch[None].to(dt) * self.beta[..., None].to(dt)


def materialize(x):
    """Concrete (s, b, n, d) streams from either layout."""
    return x.materialize() if isinstance(x, LazyStreams) else x


def expand_stream(x: torch.Tensor, num_streams: int) -> torch.Tensor:
    """(b, n, d) -> (s, b, n, d), each stream a copy (contiguous)."""
    return x[None].repeat(num_streams, *([1] * x.ndim))


def reduce_stream(x) -> torch.Tensor:
    """(s, b, n, d) -> (b, n, d) by summing streams."""
    if isinstance(x, LazyStreams):
        return (x.carried.sum(dim=0)
                + x.branch * x.beta.sum(dim=0)[..., None].to(x.branch.dtype))
    return x.sum(dim=0)


class HyperConnection(nn.Module):
    """One residual-branch router: ``forward(residuals) -> (branch_input,
    add_residual)`` with residuals (s, b, n, d) or `LazyStreams`.
    ``save_state`` keeps the width connection's forward state for its
    adjoint (K5s / K3s, then K5bs / K4s) instead of recomputing it; it adds
    no parameters."""

    def __init__(self, dim: int, num_streams: int, layer_index: int = 0,
                 save_state: bool = False):
        super().__init__()
        self.num_streams = num_streams
        self.save_state = save_state
        if num_streams == 1:
            return
        s = num_streams
        init_alpha0 = torch.zeros(s, 1)
        init_alpha0[layer_index % s, 0] = 1.0
        # column 0 routes into the branch input; columns 1..s carry streams
        self.static_alpha = nn.Parameter(torch.cat((init_alpha0, torch.eye(s)), dim=1))
        self.static_beta = nn.Parameter(torch.ones(s))
        self.dynamic_alpha_fn = nn.Parameter(torch.zeros(dim, s + 1))
        self.dynamic_alpha_scale = nn.Parameter(torch.tensor(1e-2))
        self.dynamic_beta_fn = nn.Parameter(torch.zeros(dim))
        self.dynamic_beta_scale = nn.Parameter(torch.tensor(1e-2))

    def forward(self, residuals):
        if self.num_streams == 1:
            x = materialize(residuals)[0]
            return x, lambda branch_out: (x + branch_out)[None]

        dtype = residuals.dtype
        s, b, n, d = residuals.shape
        params = (self.static_alpha, self.static_beta, self.dynamic_alpha_fn,
                  self.dynamic_alpha_scale, self.dynamic_beta_fn,
                  self.dynamic_beta_scale)
        if isinstance(residuals, LazyStreams):
            branch_input, carried, beta = hck.width_connection_fused(
                residuals.carried.reshape(s, b * n, d),
                residuals.branch.reshape(b * n, d).contiguous(),
                residuals.beta.reshape(s, b * n).contiguous(), *params,
                save_state=self.save_state)
        else:
            branch_input, carried, beta = hck.width_connection(
                residuals.reshape(s, b * n, d).contiguous(), *params,
                save_state=self.save_state)
        branch_input = branch_input.reshape(b, n, d)
        carried = carried.reshape(s, b, n, d)
        beta = beta.reshape(s, b, n)

        def add_residual(branch_out: torch.Tensor) -> LazyStreams:
            return LazyStreams(carried, branch_out.to(dtype), beta)

        return branch_input, add_residual
