"""Model tables as device tensors (port of runner.DeviceTables).

The numpy tables themselves come from
``somatic_sniper_tpu.models.tables.build_tables`` (the bit-exact host
precompute, shared with the JAX package); this module only moves them
to a device once per ``(params, device)`` and derives the per-depth
cuts the kernels read.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from somatic_sniper_tpu.models.tables import (ModelParams, ModelTables,
                                              build_tables)

MAX_W = 255  # highest fk rank the reference's w[k] counter reaches


def fk_weights_f32(theta: float, eta: float) -> np.ndarray:
    """The 256-entry f32 rank-weight table ``theta^r*(1-eta)+eta``.

    Same f32 formula as the JAX fast path's in-register weights
    (somatic_sniper_tpu/models/glfgen.py:268-275), evaluated once on the
    host: the kernel and its plain version then read identical weights,
    where three ``exp`` implementations (XLA, torch, CUDA) would each
    differ by a few ulps."""
    theta32 = np.float32(theta)
    eta32 = np.float32(eta)
    log_theta = (np.float32(np.log(np.float64(theta32))) if theta32 > 0
                 else np.float32(-1e30))
    r = np.arange(MAX_W + 1, dtype=np.float32)
    return (np.exp(r * log_theta) * (np.float32(1.0) - eta32)
            + eta32).astype(np.float32)


class DeviceTables:
    """Model tables resident on one device: f32 coef/lhet, i32 priors,
    the f32 rank-weight table, and per-slab-depth cuts for the assembly
    kernel.  The f64 fk and the qAdd table have no device reader (the
    weight table and the closed-form qAdd replace them)."""

    def __init__(self, tabs: ModelTables, device: torch.device):
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        self.params = tabs.params
        self.coef = put(tabs.coef, torch.float32)
        self.lhet = put(tabs.lhet, torch.float32)
        self.solo_prior = put(tabs.solo_prior, torch.int32)
        self.joint_prior = put(tabs.joint_prior, torch.int32)
        self.q_r_int = int(tabs.q_r_int)
        self.fk_weights = put(
            fk_weights_f32(tabs.params.theta, tabs.params.eta),
            torch.float32,
        )
        self._subs: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()

    def assembly_tables(self, D: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(``coef[4:64, :D+1, :D+1]``, ``lhet[:D+1, :D+1]``), contiguous.

        Every index the assembly forms is bounded by the slab depth:
        bar_e in [4, 63], c_tot and the others-counts <= D."""
        with self._lock:
            sub = self._subs.get(D)
            if sub is None:
                nk = D + 1
                sub = (self.coef[4:64, :nk, :nk].contiguous(),
                       self.lhet[:nk, :nk].contiguous())
                self._subs[D] = sub
            return sub


@functools.lru_cache(maxsize=8)
def _device_tables(params: ModelParams, device: torch.device) -> DeviceTables:
    return DeviceTables(build_tables(params), device)


def device_tables(tabs: ModelTables, device) -> DeviceTables:
    """Process-wide DeviceTables cache keyed by ``(params, device)``:
    the 16 MiB f32 coef upload is paid once, not once per run."""
    return _device_tables(tabs.params, torch.device(device))
