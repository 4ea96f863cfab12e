"""Power-of-two shape buckets (copy of the JAX package's bucket policy).

The decode pool pads each prompt to a bucket so that prompt lengths share a
handful of shapes. Only the two functions the port uses are copied.
"""

from __future__ import annotations

from typing import List


def bucket_size(n: int, *, min_bucket: int = 1, multiple: int = 1) -> int:
    """Smallest power-of-2 multiple of ``multiple`` that is >= ``n``, seeded
    at ``min_bucket`` so tiny inputs share one bucket."""
    if n < 0:
        raise ValueError(f"bucket_size needs n >= 0, got {n}")
    b = max(1, multiple)
    while b < min_bucket:
        b *= 2
    while b < n:
        b *= 2
    return b


def bucket_ladder(max_n: int, *, min_bucket: int = 1,
                  multiple: int = 1) -> List[int]:
    """Every bucket the policy can produce up to ``bucket_size(max_n)``,
    smallest first."""
    top = bucket_size(max_n, min_bucket=min_bucket, multiple=multiple)
    b = bucket_size(1, min_bucket=min_bucket, multiple=multiple)
    ladder = [b]
    while b < top:
        b *= 2
        ladder.append(b)
    return ladder
