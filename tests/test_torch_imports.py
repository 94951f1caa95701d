"""Import hygiene of the port: every module of dicttts_tpu_torch (its
``tools`` included), chip_smoke.py and the port's scripts
(scripts/torch_*.py, scripts/corpus_word_id_stats.py,
scripts/make_sandhi_fixture.py) import in a fresh interpreter where ``jax``
and the JAX package cannot be imported (their ``sys.modules`` entries set
to None, so any import of them, lazy ones at module level included,
raises)."""

import glob
import os
import pkgutil
import subprocess
import sys

import dicttts_tpu_torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "dicttts_tpu")


def _port_modules():
    names = [dicttts_tpu_torch.__name__]
    for info in pkgutil.walk_packages(dicttts_tpu_torch.__path__, dicttts_tpu_torch.__name__ + "."):
        names.append(info.name)
    return names


def _port_scripts():
    scripts = sorted(glob.glob(os.path.join(ROOT, "scripts", "torch_*.py")))
    return [os.path.abspath(p) for p in scripts + [os.path.join(ROOT, "scripts", name) for name in (
        "corpus_word_id_stats.py", "make_sandhi_fixture.py")]]


def test_every_port_module_imports_without_jax_or_the_jax_package():
    modules = _port_modules() + ["chip_smoke"]
    scripts = _port_scripts()
    assert len(modules) > 50 and "dicttts_tpu_torch.models.post_glow" in modules
    assert "dicttts_tpu_torch.tools.per_eval" in modules and len(scripts) >= 7
    script = "\n".join([
        "import importlib, importlib.util, sys",
        *(f"sys.modules[{name!r}] = None" for name in BLOCKED),
        "failed = []",
        f"for name in {modules!r}:",
        "    try:",
        "        importlib.import_module(name)",
        "    except Exception as e:",
        "        failed.append(f'{name}: {type(e).__name__}: {e}')",
        f"for i, path in enumerate({scripts!r}):",
        "    try:",
        "        spec = importlib.util.spec_from_file_location(f'port_script_{i}', path)",
        "        spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "    except Exception as e:",
        "        failed.append(f'{path}: {type(e).__name__}: {e}')",
        f"leaked = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r} and sys.modules[m] is not None]",
        "print('\\n'.join(failed + leaked))",
        "sys.exit(1 if failed or leaked else 0)",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
