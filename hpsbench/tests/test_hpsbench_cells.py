"""What each cell reports and warms up: its end-to-end list as
BENCHMARK.json gives it, and the buckets its merged batches can take."""

from hpsbench import spec
from hpsbench.deploy import hps

B64 = "hps-dlrm1tb.b64-c16"


def test_end_to_end_list():
    names = [m["name"] for m in spec.load(B64).end_to_end]
    assert names == ["memory_resident_mb", "setup_s"]


def test_warm_sizes():
    cell = spec.load(B64)
    assert hps.warm_sizes(cell.cfg, cell.mix) == [64, 128, 256, 512, 1024]
