"""The plain reference against hand-checked cases."""

import numpy as np

from hpsbench.reference.hps import HpsReference, dequantized


def test_int8_row_by_hand():
    row = np.array([[1.0, -0.5, 0.25, 0.0, -0.001]], np.float32)
    scale = np.float32(1.0) / np.float32(127.0)
    # 1 -> 127, -0.5 -> -63.5 -> -64 (half to even), 0.25 -> 31.75 -> 32,
    # 0 -> 0, -0.001 -> -0.127 -> 0 (+0.0, an integer)
    want = np.array([127, -64, 32, 0, 0], np.float32) * scale
    got = dequantized(row)
    assert got.tobytes() == want.tobytes()
    assert not np.signbit(got[0, 4])


def test_zero_row_and_int4():
    assert np.array_equal(dequantized(np.zeros((1, 4), np.float32)), np.zeros((1, 4)))
    row = np.array([[7.0, 3.5, -1.0]], np.float32)
    # scale 1: 7, 3.5 -> 4 (half to even), -1
    assert np.array_equal(dequantized(row, 4), np.array([[7.0, 4.0, -1.0]], np.float32))


def test_response_is_table_major_with_default_rows():
    t0 = np.array([[1.0, 2.0], [3.0, -4.0]], np.float32)
    t1 = np.array([[5.0, 6.0]], np.float32)
    ref = HpsReference([t0, t1], 8, default_value=0.0)
    out = ref.response([np.array([1, 0, -1]), np.array([0, -1, 0])])
    d0, d1 = dequantized(t0), dequantized(t1)
    want = np.concatenate([d0[1], d0[0], [0, 0], d1[0], [0, 0], d1[0]])
    assert out.tobytes() == want.astype(np.float32).tobytes()

