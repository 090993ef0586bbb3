"""Prometheus-format metrics registry (no external dependencies).

Replaces the reference's reliance on Triton's metrics endpoint
(reference docs/metrics.md:106-128; fed via
``TRITONBACKEND_ModelInstanceReportStatistics`` at hps.cc:740-761). Exposed at
``GET /metrics`` by the serving frontend in the same Prometheus text format,
so the reference's Grafana guide (docs/metrics.md:168-184) applies unchanged.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Iterable


def _esc(v) -> str:
    """Prometheus exposition label-value escaping (backslash, quote,
    newline): an unescaped quote in a model name would make the whole
    /metrics response unparseable and drop every metric from the scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels):
        with self._lock:
            self._values[tuple(sorted(labels.items()))] += value

    def value(self, **labels) -> float:
        """Public read accessor for one label set."""
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def values(self) -> dict[tuple, float]:
        """Public snapshot of every (labels) -> value pair."""
        with self._lock:
            return dict(self._values)

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        with self._lock:
            items = list(self._values.items()) or [((), 0.0)]
        for lbl, v in items:
            yield f"{self.name}{_fmt_labels(dict(lbl))} {v}"


class Gauge(Counter):
    def set(self, value: float, **labels):
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            items = list(self._values.items()) or [((), 0.0)]
        for lbl, v in items:
            yield f"{self.name}{_fmt_labels(dict(lbl))} {v}"


class Histogram:
    DEFAULT_BUCKETS = (
        50e-6, 100e-6, 250e-6, 500e-6, 1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3,
        50e-3, 100e-3, 250e-3, 500e-3, 1.0,
    )

    def __init__(self, name: str, help_: str, buckets=None):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = defaultdict(float)
        self._total: dict[tuple, int] = defaultdict(int)
        self._max: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def observe(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * len(self.buckets)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[key][i] += 1
            self._sum[key] += value
            self._total[key] += 1
            if value > self._max[key]:
                self._max[key] = value

    def mean(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            total = self._total.get(key, 0)
            return self._sum.get(key, 0.0) / total if total else 0.0

    def count(self, **labels) -> int:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._total.get(key, 0)

    def sum(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._sum.get(key, 0.0)

    def percentile(self, q: float, **labels) -> float:
        """Approximate percentile from bucket counts (upper bound)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            total = self._total.get(key, 0)
            if not total:
                return 0.0
            target = q * total
            for i, b in enumerate(self.buckets):
                if self._counts[key][i] >= target:
                    return b
            # Target beyond the last bucket: the largest OBSERVED value is
            # the honest upper bound (returning buckets[-1] under-reported
            # exactly the pathological tails this metric exists to expose).
            return self._max[key]

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        # Snapshot under the lock; yield OUTSIDE it (a partially-consumed
        # generator would otherwise hold the lock and block every observe()
        # on the serving hot path — Counter.render's pattern).
        with self._lock:
            snap = [
                (dict(key), list(self._counts[key]), self._sum[key],
                 self._total[key])
                for key in self._total
            ]
        for labels, counts, total_sum, total in snap:
            for i, b in enumerate(self.buckets):
                l2 = dict(labels, le=repr(b))
                yield f"{self.name}_bucket{_fmt_labels(l2)} {counts[i]}"
            linf = dict(labels, le="+Inf")
            yield f"{self.name}_bucket{_fmt_labels(linf)} {total}"
            yield f"{self.name}_sum{_fmt_labels(labels)} {total_sum}"
            yield f"{self.name}_count{_fmt_labels(labels)} {total}"


class MetricsRegistry:
    """Process-global registry; serving components register on import."""

    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def counter(self, name, help_) -> Counter:
        m = Counter(name, help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, name, help_) -> Gauge:
        m = Gauge(name, help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(self, name, help_, buckets=None) -> Histogram:
        m = Histogram(name, help_, buckets)
        with self._lock:
            self._metrics.append(m)
        return m

    def render(self) -> str:
        lines = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()

# Serving metric family mirroring Triton's nv_inference_* names where sensible
# (docs/metrics.md) plus HPS-specific cache metrics.
REQUEST_COUNT = REGISTRY.counter(
    "hps_inference_request_success", "Successful inference requests"
)
REQUEST_FAIL = REGISTRY.counter(
    "hps_inference_request_failure", "Failed inference requests"
)
REQUEST_LATENCY = REGISTRY.histogram(
    "hps_inference_request_duration_seconds", "End-to-end request latency"
)
QUEUE_LATENCY = REGISTRY.histogram(
    "hps_inference_queue_duration_seconds", "Time spent in the batching queue"
)
BATCH_SIZE = REGISTRY.histogram(
    "hps_inference_batch_size", "Executed batch sizes",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048),
)
SAMPLES_COUNT = REGISTRY.counter("hps_inference_samples", "Samples processed")
CACHE_HIT_RATE = REGISTRY.gauge(
    "hps_embedding_cache_hit_rate", "EWMA embedding cache hit rate"
)
PENDING_REQUESTS = REGISTRY.gauge(
    "hps_pending_requests", "Requests waiting in the scheduler queue"
)
BATCH_SW_SECONDS = REGISTRY.histogram(
    "hps_batch_frontend_sw_seconds",
    "Per executed batch: frontend software time (validate/merge/pad + "
    "response split), EXCLUDING translation + device dispatch",
)
BATCH_DISPATCH_SECONDS = REGISTRY.histogram(
    "hps_batch_dispatch_seconds",
    "Per executed batch: key->slot translation + device program + "
    "device->host transfer (includes interconnect RTT on remote-attached "
    "setups)",
)
# The stages of a request and of a merged batch (``utils/tracing.py`` spans
# of the same names): each is observed on the ``model`` label alone. The
# five dispatch stages tile BATCH_DISPATCH_SECONDS's interval, less the
# Python that joins them. A merged batch's histograms count it once it is
# answered (``tracing.held``): a failed attempt counts in none of them.
STAGE_BUCKETS = (10e-6, 25e-6) + Histogram.DEFAULT_BUCKETS
HTTP_READ_SECONDS = REGISTRY.histogram(
    "hps_http_read_seconds",
    "Per HTTP infer request: body read off the socket, JSON header, tensor "
    "views (span hps.http.read)", buckets=STAGE_BUCKETS,
)
HTTP_WRITE_SECONDS = REGISTRY.histogram(
    "hps_http_write_seconds",
    "Per HTTP infer request: response header and OUTPUT0 written to the "
    "socket (span hps.http.write)", buckets=STAGE_BUCKETS,
)
DISPATCH_LOCK_WAIT_SECONDS = REGISTRY.histogram(
    "hps_dispatch_lock_wait_seconds",
    "Per lookup: waiting for the embedding cache's lock "
    "(span hps.dispatch.lock_wait)", buckets=STAGE_BUCKETS,
)
DISPATCH_TRANSLATE_SECONDS = REGISTRY.histogram(
    "hps_dispatch_translate_seconds",
    "Per lookup: key -> slot translation and slot padding, under the cache "
    "lock (span hps.dispatch.translate)", buckets=STAGE_BUCKETS,
)
DISPATCH_ASSEMBLE_SECONDS = REGISTRY.histogram(
    "hps_dispatch_assemble_seconds",
    "Per lookup: the kernel's arguments assembled (under the cache lock), "
    "checked, packed and copied to the device (span hps.dispatch.assemble)",
    buckets=STAGE_BUCKETS,
)
DISPATCH_LAUNCH_SECONDS = REGISTRY.histogram(
    "hps_dispatch_launch_seconds",
    "Per lookup: K1's launch and the output's slices and concatenation, "
    "enqueued (span hps.dispatch.launch; with a tier miss merge, the merge "
    "too)", buckets=STAGE_BUCKETS,
)
DISPATCH_COPY_BACK_SECONDS = REGISTRY.histogram(
    "hps_dispatch_copy_back_seconds",
    "Per merged batch: waiting for the device, then its flat output copied "
    "to the host (span hps.dispatch.copy_back)", buckets=STAGE_BUCKETS,
)
# The fused ensemble's device program of one request (serving/ensemble.py),
# on the ensemble's ``model`` label: the whole (span hps.ensemble.fused) and
# its stages (.translate, .assemble, .launch, .copy_back).
ENSEMBLE_FUSED_SECONDS = REGISTRY.histogram(
    "hps_ensemble_fused_seconds",
    "Per fused ensemble request: its device program, keys in to outputs on "
    "the host (span hps.ensemble.fused)", buckets=STAGE_BUCKETS,
)
ENSEMBLE_FUSED_TRANSLATE_SECONDS = REGISTRY.histogram(
    "hps_ensemble_fused_translate_seconds",
    "Per fused DLRM ensemble request: waiting for the cache's lock, then keys "
    "to slots and the bucket's pad slots, under it "
    "(span hps.ensemble.fused.translate)", buckets=STAGE_BUCKETS,
)
ENSEMBLE_FUSED_ASSEMBLE_SECONDS = REGISTRY.histogram(
    "hps_ensemble_fused_assemble_seconds",
    "Per fused DLRM ensemble request: the lookup's arguments assembled under "
    "the cache lock, then they and the dense features copied to the device "
    "(span hps.ensemble.fused.assemble)", buckets=STAGE_BUCKETS,
)
ENSEMBLE_FUSED_LAUNCH_SECONDS = REGISTRY.histogram(
    "hps_ensemble_fused_launch_seconds",
    "Per fused DLRM ensemble request: K1, the bottom MLP, the interaction and "
    "the top MLP enqueued, no sync (span hps.ensemble.fused.launch)",
    buckets=STAGE_BUCKETS,
)
ENSEMBLE_FUSED_COPY_BACK_SECONDS = REGISTRY.histogram(
    "hps_ensemble_fused_copy_back_seconds",
    "Per fused ensemble request: waiting for the device, then the outputs "
    "copied to the host (span hps.ensemble.fused.copy_back)", buckets=STAGE_BUCKETS,
)
ENSEMBLE_FUSED_PER_REQUEST = REGISTRY.histogram(
    "hps_ensemble_fused_per_request",
    "Per answered ensemble request: 1 where the fused path served it, 0 where "
    "the staged path did (the mean is the fused share)", buckets=(0.0, 1.0),
)
ENSEMBLE_FUSED_FOLDED = REGISTRY.gauge(
    "hps_ensemble_fused_folded_table",
    "Per table of a fused DLRM ensemble (labels model, table): 1 where the "
    "interaction kernel (K3) builds its rows from the one-hot group, 0 where "
    "K1 gathers them; set when the fused server is built over the live cache",
)
K1_LAUNCHES_PER_BATCH = REGISTRY.histogram(
    "hps_k1_launches_per_batch",
    "Per merged batch: launches of K1 (gather_dequant_groups) in its "
    "dispatch, from the batcher thread's launch tally (0 on the CPU)",
    buckets=(1, 2, 4, 8, 16, 32, 64),
)
TIER_HIT = REGISTRY.counter(
    "hps_tier_hit", "Key lookups served by a storage tier (tier=dram|ssd)"
)
TIER_MISS = REGISTRY.counter(
    "hps_tier_miss", "Key lookups missing from a storage tier (tier=dram|ssd)"
)
