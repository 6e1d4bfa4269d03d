"""The port's default settings TOMLs: its own copies, packaged beside
``curvis_tpu_torch/config/settings.py``, read without the JAX package.

- each file of ``curvis_tpu_torch/config/defaults/`` equals the JAX
  package's ``curvis_tpu/config/defaults/`` file of its name byte for
  byte, and neither directory has a file the other lacks;
- in a fresh interpreter where ``curvis_tpu`` can be neither imported
  nor found (a meta-path finder refuses it, so ``find_spec`` raises),
  every settings category loads its defaults and a metric is built from
  them.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "curvis_tpu_torch" / "config" / "defaults"
JAX = REPO / "curvis_tpu" / "config" / "defaults"


def test_port_default_tomls_equal_the_jax_package_files():
    port = sorted(p.name for p in PORT.glob("*.toml"))
    assert port == sorted(p.name for p in JAX.glob("*.toml"))
    assert len(port) == 6
    for name in port:
        assert (PORT / name).read_bytes() == (JAX / name).read_bytes(), name


def test_port_settings_load_with_curvis_tpu_hidden():
    """Every category's defaults and a metric built from them, in one
    fresh interpreter (its start-up is most of the test's time)."""
    code = textwrap.dedent("""
        import importlib.abc
        import importlib.util
        import sys

        class Hide(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("curvis_tpu", "jax"):
                    raise ModuleNotFoundError(name)
                return None

        sys.meta_path.insert(0, Hide())
        for m in [m for m in sys.modules
                  if m.split(".")[0] in ("curvis_tpu", "jax")]:
            del sys.modules[m]
        try:
            importlib.util.find_spec("curvis_tpu")
            raise SystemExit("curvis_tpu was found")
        except ModuleNotFoundError:
            pass
        from curvis_tpu_torch.config import settings
        for name in ("CameraSettings", "SimulationSettings", "ImageSettings",
                     "VideoSettings", "MetricSettings"):
            s = getattr(settings, name).from_toml(None)
            assert vars(s), name
        metric = settings.MetricSettings.from_toml(None).make(device="cpu")
        assert type(metric).__name__ == "EllisMetric", metric
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("curvis_tpu", "jax"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
