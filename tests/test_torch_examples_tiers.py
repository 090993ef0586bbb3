"""Examples 03, 06 and 08 of the port against the JAX package's: the online
update through the file queue, the int4 UVM cache over the DRAM and SSD
tiers, and the lz4 Kafka stream split over a consumer group.

Tolerances: none. Lookups are bit-identical (the same f32 rows, the same
int4 quantization and dequant); 06's hit rate after warm-up is the same
number as each example prints it (two decimals; the caches of both packages
admit the same keys); 08's consumed rows
are the posted bytes, every row once.
"""

import numpy as np
import pytest

from torch_examples_common import port_example, run_jax_example
from torch_examples_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_03_online_updates_matches_jax(tmp_path):
    want = run_jax_example("03_online_updates")
    got = port_example("03_online_updates").main(device="cpu", root=tmp_path)
    np.testing.assert_array_equal(got["key"], want["key"])
    np.testing.assert_array_equal(got["before"], want["table"].vectors[0])
    jax_after = want["sess"].lookup_numpy([want["key"]])[0][0]
    np.testing.assert_array_equal(jax_after, np.full(8, 7.0, np.float32))
    np.testing.assert_array_equal(got["after"], jax_after)


def _hit_rate_line(text: str) -> str:
    (line,) = [ln for ln in text.splitlines() if ln.startswith("cache hit-rate after warm-up")]
    return line


def test_06_capacity_tiering_int4_matches_jax(tmp_path, capsys):
    want = run_jax_example("06_capacity_tiering_int4")
    jax_line = _hit_rate_line(capsys.readouterr().out)
    got = port_example("06_capacity_tiering_int4").main(device="cpu", root=tmp_path)
    assert _hit_rate_line(capsys.readouterr().out) == jax_line
    np.testing.assert_array_equal(got["keys"], want["hot"])
    np.testing.assert_array_equal(got["output"], want["out"])
    assert got["max_err"] == float(want["err"]) <= 1 / 14 + 1e-5
    assert jax_line.endswith(f"{got['hit_rate']:.2f}")
    np.testing.assert_array_equal(got["miss"], want["miss"])
    assert (got["int8_bytes"], got["int4_bytes"]) == (want["int8_bytes"], want["int4_bytes"])


def test_08_kafka_groups_compression_matches_jax():
    want = run_jax_example("08_kafka_groups_compression")
    got = port_example("08_kafka_groups_compression").main()
    assert got["total"] == want["total"] == 72
    jrows = {(tag, int(k)): v for rows in want["got"].values() for tag, keys, vecs in rows
             for k, v in zip(np.asarray(keys), np.asarray(vecs))}
    assert got["rows"].keys() == jrows.keys()
    for key, v in jrows.items():
        assert got["rows"][key].tobytes() == np.asarray(v, np.float32).tobytes(), key
    # The group split every topic's three partitions between the nodes, each
    # partition to one node.
    for topic in {t for a in got["assigned"].values() for t in a}:
        parts = [p for a in got["assigned"].values() for p in a.get(topic, [])]
        assert sorted(parts) == [0, 1, 2], (topic, got["assigned"])


def test_08_lz4_decodes_without_the_wheel():
    """Where the ``lz4`` wheel is not installed, the consumers' lz4 frames
    decode in the port's native library."""
    try:
        import lz4  # noqa: F401
        pytest.skip("the lz4 wheel is installed here")
    except ImportError:
        pass
    assert port_example("08_kafka_groups_compression").lz4_decoder() == "native"
