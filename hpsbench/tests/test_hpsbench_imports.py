"""What the harness, its load generator and its reference load."""

import json
import subprocess
import sys

from hpsbench import spec

PROBE = ("import sys, json; {imports}; "
         "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")


def loaded(*modules):
    code = PROBE.format(imports="; ".join(f"import {m}" for m in modules))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(spec.ROOT), check=True,
                         capture_output=True, text=True).stdout
    return set(json.loads(out.splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded("hpsbench.run", "hpsbench.readings", "hpsbench.reference.hps",
                  "hpsbench.deploy.hps")
    assert not mods & {"jax", "jaxlib", "flax", "hugectr_backend_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = loaded("hpsbench.reference.hps")
    assert not mods & {"jax", "jaxlib", "flax", "hugectr_backend_tpu",
                       "hugectr_backend_tpu_torch"}


def test_load_generator_loads_numpy_and_the_standard_library_only():
    mods = loaded("hpsbench.loadgen")
    assert not mods & {"torch", "jax", "hugectr_backend_tpu", "hugectr_backend_tpu_torch"}
