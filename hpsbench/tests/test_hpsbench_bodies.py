"""What ``hps-dlrm1tb.b64-c16`` sends, for three fixed seeds at the
benchmark's 8 s: the warm-up's bodies, the window's bodies in the order the
load generator's file holds them, the send order and the rows whose answers
are kept whole, each by SHA-256. The digests were taken with the harness as
it stood before the seed reached a kind and the generator took dense
features, multi-hot bags and drawn sizes: for the one-size, one-hot cell
those draw exactly what they drew."""

import hashlib

import numpy as np
import pytest

from hpsbench import run, spec, tables
from hpsbench.deploy import kind

B64 = "hps-dlrm1tb.b64-c16"
SECONDS = 8.0
PINNED = {
    3: ("1b03e60074b3fa1fcd3df1317cd6b1445f8f2c8c5f9501643d7f63a7c668a4c8",
        "5ebcb13450b5fcf2ae248b889b284b7ec38882e6d0aa4da589247701e9421904",
        "5df3dd684f9a1e1e0f9728aca5a87d6770344aacad7788e28af347f07534dd58",
        "2180a3bbaf169d36f57bbe442bf0569cdb073d72d332ade242b456a41421ae91"),
    2152400001: ("b12319aa9ffadb8257cc2798a94274cc652823a9d49cba15627e221569e0fa6d",
                 "09b384d2abc5a4a42abaa3a40abbfbeb433943e33f0bb196b5aa39ca4a1de1ea",
                 "2050fc384b679d166cfc2d02ec80250a2fa1f787be650ced16404f3111be9a93",
                 "f2ae456b75d8c38c2e35274460a5928e3f8e1b115710bb8dad181ff510026a71"),
    2**31 + 77: ("3b83149fb07701941aaf47d87eed738da2450259e120129462cb51971d5a6417",
                 "59ef4ac7e45b4c5b30fb86d7024bda2ec8e09a3f629df7e4d2fea69eeb5ea2b8",
                 "c187ca0fb5de95f33dadad424ef1ec2df6fe6965838a82346695e72d6420181f",
                 "3a9d702cd0a46bd15ef1f5f7da1eb12237645f3e0374d49eb1c65f178f72f9ec"),
}


def _bodies(cfg, requests) -> str:
    h = hashlib.sha256()
    for req in requests:
        hdr, raw = kind(cfg).encode(cfg, req)
        h.update(hdr)
        h.update(raw)
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_b64_sends_the_pinned_bytes(seed):
    cell = spec.load(B64)
    layout = tables.Layout.make(cell.cfg["rows_per_table"], seed)
    warm = run.warm_requests(cell.cfg, cell.mix, layout, seed)
    requests, _, order, keep, _ = run.window_requests(cell.cfg, cell.mix, layout, seed, SECONDS)
    got = (_bodies(cell.cfg, warm), _bodies(cell.cfg, requests),
           hashlib.sha256(np.asarray(order, "<i8").tobytes()).hexdigest(),
           hashlib.sha256(np.flatnonzero(keep).astype("<i8").tobytes()).hexdigest())
    assert got == PINNED[seed]
    assert all(r.dense is None for r in requests)
