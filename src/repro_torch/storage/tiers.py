"""Serverless storage tier models (paper Table 3).

Latency and cost characteristics of the storage services Skyrise builds on.
Latencies are modeled as lognormal distributions fit to the paper's reported
median / tail (~p99) figures; costs follow the paper's per-request, per-GiB
transfer, and per GiB-month storage prices.

The simulator never sleeps: latency draws are *accounted* into simulated
worker runtimes by the I/O handlers and the platform's critical-path model.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_P99_Z = 2.326  # standard normal quantile for p99


@dataclasses.dataclass(frozen=True)
class StorageTier:
    """One serverless storage service (row of paper Table 3)."""

    name: str
    # Latency model inputs [seconds].
    read_median_s: float
    write_median_s: float
    read_tail_s: float
    write_tail_s: float
    # Request pricing [cents per 1M requests] (Table 3 "Requests").
    read_request_cents_per_1m: float
    write_request_cents_per_1m: float
    # Transfer pricing [cents per GiB].
    read_transfer_cents_per_gib: float
    write_transfer_cents_per_gib: float
    # At-rest pricing [cents per GiB-month].
    storage_cents_per_gib_month: float
    # Sustained per-connection bandwidth [bytes/s] for large ranged reads.
    # S3-class stores stream ~90 MB/s per connection; KV stores are for
    # small values only.
    bandwidth_bytes_per_s: float = 90e6

    def _sigma(self, median_s: float, tail_s: float) -> float:
        return max(1e-6, (math.log(tail_s) - math.log(median_s)) / _P99_Z)

    def draw_latency_s(self, rng: np.random.Generator, *, write: bool,
                       nbytes: int = 0) -> float:
        """First-byte latency draw plus bandwidth term for the payload."""
        median = self.write_median_s if write else self.read_median_s
        tail = self.write_tail_s if write else self.read_tail_s
        sigma = self._sigma(median, tail)
        first_byte = float(rng.lognormal(mean=math.log(median), sigma=sigma))
        return first_byte + nbytes / self.bandwidth_bytes_per_s

    def request_cost_cents(self, *, write: bool, nbytes: int) -> float:
        per_1m = (self.write_request_cents_per_1m if write
                  else self.read_request_cents_per_1m)
        per_gib = (self.write_transfer_cents_per_gib if write
                   else self.read_transfer_cents_per_gib)
        return per_1m / 1e6 + per_gib * nbytes / 2**30

    def storage_cost_cents(self, nbytes: int, seconds: float) -> float:
        month_s = 30 * 24 * 3600.0
        return self.storage_cents_per_gib_month * (nbytes / 2**30) * (
            seconds / month_s)


# Paper Table 3, us-east-1, Aug 2024 - Jan 2025.
S3_STANDARD = StorageTier(
    name="s3-standard",
    read_median_s=0.027, write_median_s=0.040,
    read_tail_s=1.0, write_tail_s=0.500,
    read_request_cents_per_1m=40.0, write_request_cents_per_1m=500.0,
    read_transfer_cents_per_gib=0.0, write_transfer_cents_per_gib=0.0,
    storage_cents_per_gib_month=2.2,
)

S3_EXPRESS = StorageTier(
    name="s3-express",
    read_median_s=0.005, write_median_s=0.008,
    read_tail_s=0.120, write_tail_s=0.150,
    read_request_cents_per_1m=20.0, write_request_cents_per_1m=250.0,
    read_transfer_cents_per_gib=0.15, write_transfer_cents_per_gib=0.8,
    storage_cents_per_gib_month=16.0,
    bandwidth_bytes_per_s=200e6,
)

DYNAMODB = StorageTier(
    name="dynamodb",
    read_median_s=0.004, write_median_s=0.006,
    read_tail_s=0.100, write_tail_s=0.250,
    read_request_cents_per_1m=25.0, write_request_cents_per_1m=125.0,
    read_transfer_cents_per_gib=0.0, write_transfer_cents_per_gib=0.0,
    storage_cents_per_gib_month=25.0,
    bandwidth_bytes_per_s=20e6,
)

EFS = StorageTier(
    name="efs",
    read_median_s=0.006, write_median_s=0.015,
    read_tail_s=0.100, write_tail_s=0.600,
    read_request_cents_per_1m=0.0, write_request_cents_per_1m=0.0,
    read_transfer_cents_per_gib=3.0, write_transfer_cents_per_gib=6.0,
    storage_cents_per_gib_month=23.0,
)

# Zero-latency, zero-cost tier for unit tests.
LOCAL = StorageTier(
    name="local",
    read_median_s=1e-9, write_median_s=1e-9,
    read_tail_s=2e-9, write_tail_s=2e-9,
    read_request_cents_per_1m=0.0, write_request_cents_per_1m=0.0,
    read_transfer_cents_per_gib=0.0, write_transfer_cents_per_gib=0.0,
    storage_cents_per_gib_month=0.0,
    bandwidth_bytes_per_s=1e12,
)

TIERS: dict[str, StorageTier] = {
    t.name: t for t in (S3_STANDARD, S3_EXPRESS, DYNAMODB, EFS, LOCAL)
}
