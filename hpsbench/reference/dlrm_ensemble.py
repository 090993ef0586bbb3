"""Plain reference of MLPerf DLRM served behind an HPS model: PyTorch only,
float32, TF32 off. It imports neither JAX nor either HPS package and takes
nothing the program made: the rows are the int8 rows re-derived from the
fp32 tables the harness generated (``reference/hps.py``), the weights those
the kind drew from the seed.

    rows   = each table's int8 rows, dequantized; an absent key the default row
    x      = bottom MLP(dense features), ReLU after every layer
    z      = [x, row_1, ..., row_T], each rounded to bf16 (the departure below)
    pairs  = z_i . z_j for i < j (the strict upper triangle, row by row),
             the products summed in f32
    logit  = top MLP([x, pairs]), ReLU between layers, none after the last

One departure from MLPerf's DLRM, whose interaction is f32 throughout: the
program's interaction kernels round z to bf16 and sum the products in f32
(the JAX package's arithmetic), and so does this reference, at the same
place. Everything else is f32 (``x @ w + b``), with TF32 off.

``mlp_bf16=True`` is the control, the precision below the configuration's:
every MLP layer's input and weight rounded to bf16, the sums still f32.
"""

from __future__ import annotations

import numpy as np
import torch

from hpsbench.reference.hps import dequantized

#: Samples the reference runs at once.
BLOCK = 8192


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp(x: torch.Tensor, layers, last_relu: bool, bf16: bool) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        if bf16:
            x = x.bfloat16().float() @ w.bfloat16().float()
        else:
            x = x @ w
        x = x + b
        if i + 1 < len(layers) or last_relu:
            x = torch.relu(x)
    return x


def interaction(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """[x, the strict upper triangle of z z^T] with z = [x; emb] in bf16."""
    z = torch.cat([x[:, None, :], emb], dim=1).bfloat16().float()
    zz = torch.bmm(z, z.transpose(1, 2))
    f = z.shape[1]
    r, c = torch.triu_indices(f, f, 1, device=z.device)
    return torch.cat([x, zz[:, r, c]], dim=1)


class DlrmReference:
    """``tables[t]``: table t's fp32 rows as generated; ``bottom`` and
    ``top``: [(w [in, out], b [out])] float32 arrays. The dequantized tables
    are held on ``device`` as one array."""

    def __init__(self, tables, bottom, top, default_value: float = 0.0, device="cpu",
                 mlp_bf16: bool = False, deq=None):
        self.device = torch.device(device)
        self.deq = deq if deq is not None else torch.from_numpy(
            np.concatenate([dequantized(t, 8) for t in tables])).to(self.device)
        self.offsets = np.cumsum([0] + [len(t) for t in tables])[:-1]
        self.default_value = float(default_value)
        self.mlp_bf16 = mlp_bf16

        def put(layers):
            return [(torch.from_numpy(np.asarray(w, np.float32)).to(self.device),
                     torch.from_numpy(np.asarray(b, np.float32)).to(self.device))
                    for w, b in layers]

        self.bottom, self.top = put(bottom), put(top)

    def control(self) -> "DlrmReference":
        """The same reference with bf16 MLP operands, sharing the tables."""
        ref = DlrmReference.__new__(DlrmReference)
        ref.__dict__.update(self.__dict__, mlp_bf16=True)
        return ref

    def _emb(self, rows_per_table) -> torch.Tensor:
        """[N, T, D]: the rows of N samples, one key a table (-1: absent)."""
        rows = np.stack([np.asarray(r, np.int64) for r in rows_per_table], axis=1)
        glob = torch.from_numpy(np.where(rows < 0, 0, rows + self.offsets)).to(self.device)
        emb = self.deq[glob]
        absent = torch.from_numpy(rows < 0).to(self.device)
        return emb.masked_fill(absent[..., None], self.default_value)

    @torch.no_grad()
    def logits(self, dense: np.ndarray, rows_per_table) -> np.ndarray:
        """[N] logits of N samples: ``dense`` [N, num_dense], the rows of
        each table [N]."""
        no_tf32()
        x = torch.from_numpy(np.asarray(dense, np.float32)).to(self.device)
        x = mlp(x, self.bottom, True, self.mlp_bf16)
        h = interaction(x, self._emb(rows_per_table))
        return mlp(h, self.top, False, self.mlp_bf16)[:, 0].cpu().numpy()

    def requests(self, reqs, block: int = BLOCK) -> list:
        """Each request's logits (``Request.dense``, ``.rows``), worked out
        in blocks of about ``block`` samples."""
        out, i = [], 0
        while i < len(reqs):
            j, n = i, 0
            while j < len(reqs) and (n == 0 or n + reqs[j].samples <= block):
                n += reqs[j].samples
                j += 1
            part = reqs[i:j]
            got = self.logits(np.concatenate([r.dense for r in part]),
                              [np.concatenate([r.rows[t] for r in part])
                               for t in range(len(part[0].rows))])
            ends = np.cumsum([r.samples for r in part])
            out.extend(np.split(got, ends[:-1]))
            i = j
        return out
