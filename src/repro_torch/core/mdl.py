"""MDL-based index learning objective (paper §3).

``MDL(M, D) = L(M) + alpha * L(D|M)`` where

* ``L(M)`` — prediction cost: model size in parameters/bytes, or the number
  of arithmetic ops to evaluate ``M(x)`` (mechanism-reported).
* ``L(D|M)`` — expected correction cost: ``E[log2|y - y_hat| + 1]`` for a
  binary/exponential search around the prediction.

These are the exact instantiations the paper uses (§3.1 "Two Example
Instantiations", §3.2 "Choice of L(M) and L(D|M)").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = ["correction_cost", "mae", "MDLReport", "mdl_report"]


def correction_cost(y: np.ndarray, y_hat: np.ndarray) -> float:
    """L(D|M) = E[log2(|y - y_hat|) + 1]  (binary-search correction cost)."""
    err = np.abs(np.asarray(y, dtype=np.float64) - np.asarray(y_hat, dtype=np.float64))
    return float(np.mean(np.log2(np.maximum(err, 1.0)) + 1.0))


def mae(y: np.ndarray, y_hat: np.ndarray) -> float:
    """Mean absolute error between true and predicted positions (§6.1)."""
    return float(np.mean(np.abs(np.asarray(y, np.float64) - np.asarray(y_hat, np.float64))))


@dataclasses.dataclass
class MDLReport:
    """One mechanism evaluated under the MDL framework."""

    name: str
    l_model_params: int        # L(M) as parameter count
    l_model_ops: int           # L(M) as prediction op count
    l_model_bytes: int         # L(M) as bytes (paper's index-size accounting)
    l_data_given_model: float  # L(D|M), log2 correction cost
    mae: float
    max_abs_err: float         # the paper's E (drives sample-size bound)
    alpha: float = 1.0

    @property
    def mdl(self) -> float:
        """Description length with L(M) in params (paper Eq. 1)."""
        return self.l_model_params + self.alpha * self.l_data_given_model


def mdl_report(
    name: str,
    mechanism,
    x: np.ndarray,
    y: np.ndarray,
    alpha: float = 1.0,
    payload_bytes: int = 0,
) -> MDLReport:
    """Evaluate a fitted mechanism on (x, y) under the MDL framework."""
    y_hat = mechanism.predict(x)
    err = np.abs(np.asarray(y, np.float64) - y_hat)
    size_fn: Optional[Callable[[int], int]] = getattr(mechanism, "size_bytes", None)
    if size_fn is None and getattr(mechanism, "plm", None) is not None:
        size_bytes = mechanism.plm.size_bytes(payload_bytes)
    elif size_fn is not None:
        size_bytes = mechanism.size_bytes(payload_bytes)
    else:
        size_bytes = 8 * mechanism.param_count()
    return MDLReport(
        name=name,
        l_model_params=int(mechanism.param_count()),
        l_model_ops=int(mechanism.prediction_ops()),
        l_model_bytes=int(size_bytes),
        l_data_given_model=correction_cost(y, y_hat),
        mae=mae(y, y_hat),
        max_abs_err=float(max(err.max(), 1.0)),
        alpha=alpha,
    )
