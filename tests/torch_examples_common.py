"""What the tests of the port's examples, tools and entry point share:
running a JAX example in-process, loading its port, one torch thread, and
the environment of a tool run as a subprocess."""

import importlib
import os
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def one_torch_thread():
    """These tests run small ops on the CPU beside other test workers: one
    intra-op thread does them at a third of the CPU time of eight and
    leaves the cores to the other workers (the JAX package's latency tests
    among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tool_env() -> dict:
    """The environment of a tool run as a subprocess: the repo importable,
    JAX on the CPU, one OpenMP thread."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_jax_example(name: str) -> dict:
    """Run the JAX package's ``examples/<name>.py`` in this process. -> its
    globals (tables, keys, params, outputs)."""
    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"))


def port_example(name: str):
    return importlib.import_module(f"hugectr_backend_tpu_torch.examples.{name}")


def np_tree(params):
    """A Flax params tree as numpy arrays (what ``load_flax_*_params`` take)."""
    import jax

    return jax.tree_util.tree_map(np.asarray, params)
