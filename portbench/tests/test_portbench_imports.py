"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole), and the reference loads nothing of the
port."""

import subprocess
import sys

from portbench.imports import forbidden_loaded
from portbench.spec import PKG, ROOT


def test_top_level_names_compared_whole():
    assert forbidden_loaded({"shadowkv_tpu_torch": 1,
                             "shadowkv_tpu_torch.models.engine": 1,
                             "jaxtyping": 1, "flax_like": 1}) == []
    assert forbidden_loaded({"shadowkv_tpu.models": 1, "jax.numpy": 1,
                             "jaxlib": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib", "shadowkv_tpu"]


def _loaded_after(imports: str) -> set:
    code = (f"import sys; {imports}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_path_loads_no_jax():
    mods = ["portbench.run", "portbench.harness", "portbench.port",
            "portbench.calibrate", "portbench.faults",
            "portbench.traffic.decode_rounds", "portbench.traffic.prefill_repeat"]
    mods += [f"portbench.metrics.{p.stem}" for p in (PKG / "metrics").glob(
        "[a-z]*.py")]
    names = _loaded_after("; ".join(f"import {m}" for m in mods))
    assert "shadowkv_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "shadowkv_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = _loaded_after("import portbench.reference.shadow, "
                          "portbench.reference.compare")
    assert not names & {"shadowkv_tpu_torch", "shadowkv_tpu", "jax"}
    for p in (PKG / "reference").glob("*.py"):
        text = p.read_text()
        assert "import shadowkv" not in text and "from shadowkv" not in text
