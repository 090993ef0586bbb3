"""Model lifecycle management: load / unload / version / refresh scheduling.

Port of the JAX package's serving/model_manager.py. ``ModelManager.create``
serves on the card (``cuda:<id>`` for each id of ``deployed_device_list``)
unless it is given ``device="cpu"``; with no card it raises, and an id past
the visible cards raises a ``ValueError`` that names it.

Merges the responsibilities of the reference's ``ModelState``
(config validation, embedding-cache lifecycle, refresh timers — reference
hps_backend/src/model_state.cpp:66-432) and the backend-global model-version
bookkeeping (reference backend.cpp:83-99, hps.cc:163-274):

- ``load(model)``: update tiers + create caches + sessions + batcher per
  deployed device; on a version bump, re-parse + schedule a one-shot async
  cache refresh after ``refresh_delay`` (reference model_state.cpp:413-418)
  and a periodic refresh every ``refresh_interval`` seconds (:422-427).
- ``unload(model)``: drain the batcher, destroy per-model caches (reference
  ModelState destructor, model_state.cpp:108-122).
- ``freeze_sparse`` skips tier re-load during refresh (model_state.cpp:131-135).
- explicit model control: like ``tritonserver --model-control-mode=explicit``
  (reference README.md:161-168), models can be loaded/unloaded at runtime.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from hugectr_backend_tpu_torch.config.params import InferenceParams, ParameterServerConfig
from hugectr_backend_tpu_torch.lookup.session import LookupSession
from hugectr_backend_tpu_torch.ps.parameter_server import HierParameterServer
from hugectr_backend_tpu_torch.serving import metrics
from hugectr_backend_tpu_torch.serving.scheduler import ContinuousBatcher, RequestError
from hugectr_backend_tpu_torch.utils.logging import get_logger
from hugectr_backend_tpu_torch.utils.timer import Timer

log = get_logger("hps_tpu.models")


class _LoadedModel:
    def __init__(self, params: InferenceParams, version: int):
        self.params = params
        self.version = version
        self.sessions: dict[int, LookupSession] = {}
        self.batchers: dict[int, ContinuousBatcher] = {}
        self.timer = Timer()
        self._rr = 0

    def pick_device(self) -> int:
        devs = list(self.batchers.keys())
        self._rr = (self._rr + 1) % len(devs)
        return devs[self._rr]


class ModelManager:
    def __init__(self, ps: HierParameterServer):
        self.ps = ps
        self._models: dict[str, _LoadedModel] = {}
        self._lock = threading.Lock()

    @classmethod
    def create(cls, ps_source, load_all: bool = True, device=None) -> "ModelManager":
        """Build PS + manager; optionally load every configured model (the
        reference's non-explicit model-control default). ``device="cpu"``
        serves everything on the CPU."""
        ps = HierParameterServer.create(ps_source, device=device)
        mgr = cls(ps)
        if load_all:
            for name in ps.get_hps_model_configuration_map():
                mgr.load(name)
        return mgr

    # ---------------------------------------------------------------- control

    def load(self, model_name: str, version: Optional[int] = None) -> None:
        """Load or reload (new version) a model (reference hps.cc:163-247)."""
        with self._lock:
            params = self.ps.get_model_params(model_name)
            prev = self._models.get(model_name)
            prev_version = prev.version if prev else self.ps.get_model_version(model_name)
            new_version = version if version is not None else (prev_version or 1)
            # The PS's version map persists across unload, so an
            # unload -> load(new version) redeploy still re-parses the
            # tiers (previously `prev is not None` gated the re-parse and
            # the sequence silently served the old weights as the new
            # version).
            version_changed = bool(prev_version) and new_version != prev_version

            if prev is None or version_changed:
                if version_changed:
                    # Online redeploy: re-load tiers for the new version
                    # (reference hps.cc:207-219 re-parses the PS on version
                    # change). The JAX package first re-points a model
                    # repository's files at the version dir; for ps.json
                    # models that is a no-op, and model repositories are
                    # ROADMAP queue A item 6.
                    self.ps.update_database_per_model(params)
                if model_name not in self.ps._caches:
                    self.ps.create_embedding_cache_per_model(model_name)
                m = _LoadedModel(params, new_version)
                # Sharded models span deployed_device_list with ONE
                # mesh-wide instance (params.instance_devices); replicated
                # models get one instance per listed device.
                for dev in params.instance_devices:
                    cache = self.ps.get_embedding_cache(model_name, dev)
                    sess = LookupSession.create(params, cache)
                    m.sessions[dev] = sess
                    m.batchers[dev] = ContinuousBatcher(params, sess, dev)
                if prev is not None:
                    prev.timer.stop(join=False)
                    for b in prev.batchers.values():
                        b.shutdown()
                self._models[model_name] = m
                self.ps.update_model_version(model_name, new_version)

                # Refresh scheduling (reference model_state.cpp:413-427).
                if version_changed:
                    m.timer.startonce(
                        params.refresh_delay, lambda: self._refresh_model(model_name)
                    )
                if params.refresh_interval > 0:
                    m.timer.start(
                        params.refresh_interval, lambda: self._refresh_model(model_name)
                    )
                log.info("loaded model %s version %d on devices %s",
                         model_name, new_version, params.deployed_devices)

    def unload(self, model_name: str) -> None:
        with self._lock:
            m = self._models.pop(model_name, None)
            if m is None:
                return
            m.timer.stop(join=False)
            for b in m.batchers.values():
                b.shutdown()
            # Reference destroys the per-model cache when PS and model versions
            # agree (model_state.cpp:108-122); we always destroy on unload.
            self.ps.destroy_embedding_cache_per_model(model_name)
            log.info("unloaded model %s", model_name)

    def _refresh_model(self, model_name: str):
        """EmbeddingCacheRefresh equivalent (reference model_state.cpp:125-178)."""
        m = self._models.get(model_name)
        if m is None:
            return
        t0 = time.perf_counter()
        if not m.params.freeze_sparse:
            self.ps.update_database_per_model(m.params)
        if m.params.use_gpu_embedding_cache:
            for dev in m.params.instance_devices:
                self.ps.refresh_embedding_cache(model_name, dev)
                cache = self.ps.get_embedding_cache(model_name, dev)
                for t in range(cache.num_tables):
                    metrics.CACHE_HIT_RATE.set(
                        cache.hit_meter.rate(t), model=model_name, table=str(t)
                    )
        log.info(
            "refreshed embedding cache of %s in %.1f ms",
            model_name, (time.perf_counter() - t0) * 1e3,
        )

    # ----------------------------------------------------------------- queries

    def is_loaded(self, model_name: str) -> bool:
        return model_name in self._models

    def loaded_models(self) -> list[dict]:
        return [
            {"name": n, "version": str(m.version), "state": "READY"}
            for n, m in self._models.items()
        ]

    def infer(self, model_name: str, keys: np.ndarray, num_keys, timeout=60.0):
        m = self._models.get(model_name)
        if m is None:
            raise RequestError(f"model {model_name!r} is not loaded")
        dev = m.pick_device()
        return m.batchers[dev].infer(keys, num_keys, timeout=timeout)

    def shutdown(self):
        for name in list(self._models):
            self.unload(name)
