"""The port imports neither ``jax`` nor anything of ``repro``: in a fresh
interpreter that refuses both, every module of ``repro_torch`` imports and
a tiny prefill runs on the CPU."""
import os
import subprocess
import sys

GUARD = r'''
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)

import torch
from repro_torch.core.suite import build_arch
built = build_arch("gemma-2b", {"n_layers": 1}, device="cpu")
model = built.model
logits, cache = model.prefill({"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                              model.init_cache(1, 8))
assert logits.shape == (1, 1, built.cfg.vocab)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print("modules", len(names))
'''


def test_port_imports_no_jax_and_no_reference():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    r = subprocess.run([sys.executable, "-c", GUARD], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 20
