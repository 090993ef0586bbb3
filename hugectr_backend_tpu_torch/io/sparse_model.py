"""Sparse model file format: binary `key` + `emb_vector` pairs.

On-disk format is byte-compatible with the reference
(reference docs/architecture.md:185-218 and the writer in reference
samples/hps-triton-ensemble/01_model_training.ipynb `convert_to_sparse_model`):

    <table_dir>/
        key         : int64 little-endian (native), one per row, any order
        emb_vector  : float32 little-endian, embedding_dim per row, 1:1 with key

A quantized sidecar variant (TPU-native extension for parity-testable INT8/FP8
deployments) adds:

    <table_dir>/
        emb_vector.q8      : int8 row-quantized values (rows x dim)
        emb_vector.scale   : float32 per-row scale (rows)
        quant_meta.json    : {"format": "int8-rowwise"|"fp8e4m3-rowwise", "dim": D}

Remote-FS prefixes (hdfs://, s3://, gs://, http(s)://) delegate to a
pluggable fetcher registry (the reference supports them via its FileSystem
layer, docs/hierarchical_parameter_server.md:189): register a
``scheme -> fetch(uri) -> local_path`` callable via
:func:`register_remote_fetcher`, or install ``fsspec`` (+ the scheme's
driver) and the default fetcher stages the directory to a local cache.
Without either, remote URIs raise an actionable error.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

_REMOTE_PREFIXES = ("hdfs://", "s3://", "gs://", "https://", "http://")

# scheme (e.g. "s3") -> callable(uri: str) -> local directory path.
# Deployments plug their staging logic here; the default tries fsspec.
REMOTE_FETCHERS: dict = {}


def register_remote_fetcher(scheme: str, fetch) -> None:
    """Register a remote-FS fetcher: ``fetch(uri) -> local_path`` stages the
    sparse-model directory locally (mirror of the reference's FileSystem
    layer, doc:189)."""
    REMOTE_FETCHERS[scheme.lower()] = fetch


def _fsspec_fetch(uri: str) -> str:
    """Default fetcher: stage a remote sparse-model dir via fsspec."""
    import hashlib
    import tempfile

    try:
        import fsspec
    except ImportError as e:
        raise NotImplementedError(
            f"Remote path {uri!r}: no fetcher registered for its scheme and "
            "fsspec is not installed. Either stage the files to a local "
            "path, pip-install fsspec + the scheme's driver, or register a "
            "fetcher via hugectr_backend_tpu_torch.io.sparse_model."
            "register_remote_fetcher(scheme, fetch_fn)."
        ) from e
    try:
        fs, _, (path,) = fsspec.get_fs_token_paths(uri)
        # Cache key = uri + a best-effort remote fingerprint (file names,
        # sizes, mtimes): re-deploying new weights to the same URI restages
        # instead of silently serving the old copy forever.
        h = hashlib.sha1(uri.encode())
        try:
            for info in sorted(
                fs.find(path, detail=True).values(),
                key=lambda i: str(i.get("name", "")),
            ):
                h.update(
                    f"{info.get('name')}|{info.get('size')}|"
                    f"{info.get('mtime', info.get('LastModified', ''))}".encode()
                )
        except Exception:
            pass  # listing unsupported: fall back to uri-only key
        dest = Path(tempfile.gettempdir()) / ("hps_sparse_" + h.hexdigest()[:16])
        if not dest.exists():
            # Stage into a PROCESS-UNIQUE dir: a shared fixed .staging path
            # let two concurrent fetchers (two serving processes, or two
            # models on one URI) corrupt each other's download and made
            # the loser's os.replace fail on the now-existing dest.
            import shutil

            stage_root = Path(tempfile.mkdtemp(
                prefix=dest.name + ".staging.", dir=dest.parent))
            tmp = stage_root / "d"
            fs.get(path, str(tmp), recursive=True)
            # fsspec may nest the source dir under its basename when the
            # target exists; unwrap a lone inner directory so callers see
            # <dest>/key etc. directly.
            entries = list(tmp.iterdir()) if tmp.is_dir() else []
            basename = str(path).rstrip("/").rsplit("/", 1)[-1]
            if (
                len(entries) == 1
                and entries[0].is_dir()
                and entries[0].name == basename
            ):
                tmp = entries[0]
            try:
                os.replace(tmp, dest)
            except OSError:
                # A concurrent fetcher won the publish; its copy is a
                # complete download of the same fingerprint — use it.
                if not dest.exists():
                    raise
            shutil.rmtree(stage_root, ignore_errors=True)
    except Exception as e:
        raise NotImplementedError(
            f"Remote path {uri!r}: staging via fsspec failed ({e!r}). "
            "Stage the files to a local path, install/configure the "
            "scheme's fsspec driver, or register a fetcher via "
            "hugectr_backend_tpu_torch.io.sparse_model."
            "register_remote_fetcher(scheme, fetch_fn)."
        ) from e
    return str(dest)


@dataclasses.dataclass
class SparseModelTable:
    """An embedding table loaded from (or destined for) disk."""

    keys: np.ndarray  # int64 [rows]
    vectors: np.ndarray  # float32 [rows, dim]

    @property
    def num_rows(self) -> int:
        return int(self.keys.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1]) if self.vectors.ndim == 2 else 0


def _check_local(path: str | os.PathLike) -> Path:
    s = str(path)
    for p in _REMOTE_PREFIXES:
        if s.startswith(p):
            scheme = s.split("://", 1)[0].lower()
            fetch = REMOTE_FETCHERS.get(scheme, _fsspec_fetch)
            return Path(fetch(s))
    return Path(s)


def _reject_remote_write(path) -> None:
    s = str(path)
    for p in _REMOTE_PREFIXES:
        if s.startswith(p):
            raise ValueError(
                f"cannot write a sparse model to remote URI {s!r}: writes "
                "would land in the local fetch cache and never upload "
                "(remote prefixes are read-only here). Write locally and "
                "upload with your object-store tooling."
            )


def write_sparse_model(
    table_dir: str | os.PathLike,
    keys: np.ndarray,
    vectors: np.ndarray,
) -> None:
    """Write a table in the reference's binary format (docs/architecture.md:185-218)."""
    _reject_remote_write(table_dir)
    d = Path(table_dir)
    d.mkdir(parents=True, exist_ok=True)
    keys = np.ascontiguousarray(np.asarray(keys, dtype="<i8"))
    vectors = np.ascontiguousarray(np.asarray(vectors, dtype="<f4"))
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {keys.shape}")
    if vectors.ndim != 2 or vectors.shape[0] != keys.shape[0]:
        raise ValueError(
            f"vectors must be [num_keys, dim]; got {vectors.shape} for {keys.shape[0]} keys"
        )
    (d / "key").write_bytes(keys.tobytes())
    (d / "emb_vector").write_bytes(vectors.tobytes())


def read_sparse_model(
    table_dir: str | os.PathLike,
    embedding_dim: int | None = None,
) -> SparseModelTable:
    """Read a table written by `write_sparse_model` or by the reference's trainer.

    If ``embedding_dim`` is None it is inferred from file sizes
    (len(emb_vector)/4 must divide evenly by len(key)/8).
    """
    d = _check_local(table_dir)
    key_path = d / "key"
    vec_path = d / "emb_vector"
    if not key_path.exists() or not vec_path.exists():
        raise FileNotFoundError(
            f"Sparse model dir {d} must contain 'key' and 'emb_vector' files "
            "(reference docs/architecture.md:185-218)"
        )
    keys = np.frombuffer(key_path.read_bytes(), dtype="<i8")
    flat = np.frombuffer(vec_path.read_bytes(), dtype="<f4")
    n = keys.shape[0]
    if n == 0:
        dim = embedding_dim or 0
        return SparseModelTable(keys=keys.copy(), vectors=flat.reshape(0, dim).copy())
    if embedding_dim is None:
        if flat.shape[0] % n != 0:
            raise ValueError(
                f"emb_vector size {flat.shape[0]} not divisible by num keys {n}"
            )
        embedding_dim = flat.shape[0] // n
    if flat.shape[0] != n * embedding_dim:
        raise ValueError(
            f"emb_vector holds {flat.shape[0]} floats, expected "
            f"{n} keys x {embedding_dim} dim = {n * embedding_dim}"
        )
    return SparseModelTable(
        keys=keys.copy(), vectors=flat.reshape(n, embedding_dim).copy()
    )


# ---------------------------------------------------------------------------
# Quantized sidecar (TPU-native extension)
# ---------------------------------------------------------------------------


# format name -> (file name, numpy dtype, stored width divisor)
_SIDECAR_FMT = {
    "int8-rowwise": ("emb_vector.q8", np.int8, 1),
    "int4-rowwise": ("emb_vector.q4", np.uint8, 2),  # nibble-packed
}


def write_quantized_sidecar(
    table_dir: str | os.PathLike,
    qvalues: np.ndarray,
    scales: np.ndarray,
    fmt: str = "int8-rowwise",
    logical_dim: "int | None" = None,
) -> None:
    """``logical_dim`` is required for packed formats (int4 stores dim//2
    bytes per row); for int8 it defaults to qvalues' width."""
    if fmt not in _SIDECAR_FMT:
        raise ValueError(f"unknown sidecar format {fmt!r}")
    fname, dtype, div = _SIDECAR_FMT[fmt]
    _reject_remote_write(table_dir)
    d = Path(table_dir)
    d.mkdir(parents=True, exist_ok=True)
    qvalues = np.ascontiguousarray(qvalues)
    scales = np.ascontiguousarray(np.asarray(scales, dtype="<f4")).reshape(-1)
    if qvalues.shape[0] != scales.shape[0]:
        raise ValueError("qvalues and scales row counts differ")
    dim = int(logical_dim if logical_dim is not None else qvalues.shape[1] * div)
    if qvalues.shape[1] * div != dim:
        raise ValueError(
            f"qvalues width {qvalues.shape[1]} does not match dim {dim} "
            f"for format {fmt}"
        )
    (d / fname).write_bytes(qvalues.astype(dtype).tobytes())
    (d / "emb_vector.scale").write_bytes(scales.tobytes())
    (d / "quant_meta.json").write_text(
        json.dumps({"format": fmt, "dim": dim})
    )


def read_quantized_sidecar(table_dir: str | os.PathLike):
    """-> (q, scales, meta); q is [rows, dim] int8 or [rows, dim//2] packed
    uint8 depending on meta['format']."""
    d = _check_local(table_dir)
    meta = json.loads((d / "quant_meta.json").read_text())
    fmt = meta.get("format", "int8-rowwise")
    if fmt not in _SIDECAR_FMT:
        raise ValueError(f"unknown sidecar format {fmt!r}")
    fname, dtype, div = _SIDECAR_FMT[fmt]
    dim = int(meta["dim"])
    q = np.frombuffer((d / fname).read_bytes(), dtype=dtype).reshape(
        -1, dim // div
    )
    s = np.frombuffer((d / "emb_vector.scale").read_bytes(), dtype="<f4")
    return q.copy(), s.copy(), meta


def sidecar_matches(table_dir: str | os.PathLike, quant: str) -> bool:
    """True when a quantized sidecar exists for ``quant`` ('int8'/'int4') and
    is at least as fresh as the f32 ``emb_vector`` it derives from (a stale
    sidecar after re-training must never win)."""
    fmt = {"int8": "int8-rowwise", "int4": "int4-rowwise"}.get(quant)
    if fmt is None:
        return False
    try:
        d = _check_local(table_dir)
    except Exception:
        return False
    fname, _, _ = _SIDECAR_FMT[fmt]
    meta_p, q_p, vec_p = d / "quant_meta.json", d / fname, d / "emb_vector"
    if not (meta_p.exists() and q_p.exists() and (d / "emb_vector.scale").exists()):
        return False
    try:
        if json.loads(meta_p.read_text()).get("format") != fmt:
            return False
        if vec_p.exists() and q_p.stat().st_mtime < vec_p.stat().st_mtime:
            return False
    except Exception:
        return False
    return True
