"""Bucketed batching for inputs of any length (counterpart of
``gpflow_tpu/utilities/bucketing.py``).

``bucketize`` wraps any ``fn(X, ...)`` whose first axis is the batch: the
input is zero-padded up to its bucket's size, so that ``fn`` sees at most one
shape per bucket (a fixed-shape exported program, ``export_serving(...,
batch_size=...)``, serves any N this way), and the outputs are sliced back
to the true length. The default buckets are powers of two.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..config import default_device

__all__ = ["bucket_size_for", "bucketize", "pad_to_bucket"]


def bucket_size_for(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """The smallest bucket that holds n; by default the next power of two
    (at least 1). Raises for n < 0 and where no bucket holds n."""
    if n < 0:
        raise ValueError(f"batch size must be non-negative, got {n}")
    if buckets is None:
        return 1 if n <= 1 else 1 << (n - 1).bit_length()
    for b in sorted(buckets):
        if b >= n:
            return int(b)
    raise ValueError(f"no bucket >= {n} in {sorted(buckets)}")


def _as_tensor(X: Any) -> torch.Tensor:
    """A tensor as it is; anything else (a numpy array) as a tensor on the
    default device."""
    if isinstance(X, torch.Tensor):
        return X
    return torch.as_tensor(np.asarray(X), device=default_device())


def pad_to_bucket(X: Any, buckets: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, int]:
    """Zero-pads the first axis up to its bucket's size; returns (padded, n)."""
    X = _as_tensor(X)
    n = X.shape[0]
    b = bucket_size_for(n, buckets)
    if b == n:
        return X, n
    return torch.cat([X, X.new_zeros((b - n,) + tuple(X.shape[1:]))]), n


def bucketize(
    fn: Callable[..., Any],
    buckets: Optional[Sequence[int]] = None,
    unpad: str = "matching",
) -> Callable[..., Any]:
    """Wraps ``fn`` so that its first argument is padded to a bucket's size
    and the padded axes of its outputs are sliced back to the true length.

    ``unpad`` says which output axes are batch axes:

    * ``"matching"`` (default): every axis whose length is the padded size,
      so [b, P] means, [b] vectors and full covariances [b, b] or [P, b, b]
      are all cut back. A non-batch axis that happens to have the padded
      length (P outputs with P equal to the bucket) is cut too: use
      ``"leading"`` there.
    * ``"leading"``: axis 0 only; a full covariance's columns are then the
      caller's to cut.

    An output with no axis of the padded length (``fn`` reduced over the
    batch) raises ``ValueError`` where padding happened: the zero rows went
    into it, and no slice can take them out."""
    if unpad not in ("matching", "leading"):
        raise ValueError(f"unpad must be 'matching' or 'leading', got {unpad!r}")

    def wrapper(X: Any, *args: Any, **kwargs: Any) -> Any:
        Xp, n = pad_to_bucket(X, buckets)
        b = Xp.shape[0]
        out = fn(Xp, *args, **kwargs)
        if b == n:  # no padding happened; nothing to cut
            return out

        def cut(a: Any) -> Any:
            if not hasattr(a, "shape"):
                return a
            shape = tuple(a.shape)
            has_batch_axis = len(shape) >= 1 and (shape[0] == b if unpad == "leading" else b in shape)
            if not has_batch_axis:
                raise ValueError(
                    f"bucketize: output of shape {shape} has no axis equal to the padded batch "
                    f"size {b}; it was computed over zero-pad rows and cannot be unpadded. Return "
                    f"per-row outputs and reduce outside the wrapper (or mask rows >= n inside fn)."
                )
            if unpad == "leading":
                return a[:n]
            return a[tuple(slice(0, n) if d == b else slice(None) for d in shape)]

        return tree_map(cut, out)

    return wrapper
