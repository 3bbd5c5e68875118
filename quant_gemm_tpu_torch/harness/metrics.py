"""Error metrics for differential testing: a copy of the JAX package's
``harness/metrics.py::ErrorMetrics``.  ``nmse`` normalizes by
``mean(ref^2)`` (the kernels' thresholds), ``nmse_var`` by ``var(ref)``;
both in float64 on numpy arrays.  ``NMSE_VS_FP32`` and
``NMSE_KERNEL_VS_GOLDEN`` are its thresholds."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ErrorMetrics:
    mse: float
    nmse: float  # mse / mean(ref^2)
    nmse_var: float  # mse / var(ref)
    max_abs: float
    mean_abs: float

    @staticmethod
    def compute(result, reference) -> "ErrorMetrics":
        res = np.asarray(result, np.float64).ravel()
        ref = np.asarray(reference, np.float64).ravel()
        if res.shape != ref.shape:
            raise ValueError(f"result {res.shape} vs reference {ref.shape}")
        err = res - ref
        mse = float(np.mean(err**2))
        denom = float(np.mean(ref**2))
        var = float(np.var(ref))
        return ErrorMetrics(
            mse=mse,
            nmse=mse / denom if denom > 0 else (0.0 if mse == 0 else np.inf),
            nmse_var=mse / var if var > 0 else (0.0 if mse == 0 else np.inf),
            max_abs=float(np.max(np.abs(err))) if err.size else 0.0,
            mean_abs=float(np.mean(np.abs(err))) if err.size else 0.0,
        )


# Per-format NMSE thresholds against float32, and a kernel's against the
# integer golden (float32 accumulation against the golden's float64):
# the JAX package's values
NMSE_VS_FP32 = {
    "q4_0": 0.015,
    "q4_1": 0.015,
    "q5_0": 0.01,
    "q5_1": 0.01,
    "q8_0": 0.005,
    "q8_1": 0.005,
}
NMSE_KERNEL_VS_GOLDEN = 1e-9


__all__ = ["ErrorMetrics", "NMSE_VS_FP32", "NMSE_KERNEL_VS_GOLDEN"]
