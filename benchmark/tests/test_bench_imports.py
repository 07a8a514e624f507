"""What the benchmark loads: no JAX, jaxlib, flax or mad_tpu in the
command's process, and nothing of the program in the reference."""

import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

PROBE = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
{imports}
print(",".join(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def loaded(imports: str) -> set:
    code = PROBE.format(bench=str(BENCH), root=str(BENCH.parent),
                        imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH.parent)
    return set(out.stdout.strip().split(","))


def test_command_loads_no_jax_nor_mad_tpu():
    names = loaded(
        "import runpy\n"
        "import run\n"
        "from harness import registry, runner, cell\n"
        "c = cell.Cell.__init__\n"
        "import mad_tpu_torch.engine.docking, mad_tpu_torch.engine.pipeline\n"
        "for j in ('fit', 'screen'):\n"
        "    for name in registry.job(j).LAYERS:\n"
        "        registry.layer(name)\n"
        "registry.system('homomer')\n"
        "import mad_tpu_torch.engine.assemble, mad_tpu_torch.core.config\n"
        "spec = registry.benchmark()\n"
        "for kind in ('end_to_end', 'per_layer'):\n"
        "    for m in spec[kind]:\n"
        "        registry.reader(m['name'])\n")
    assert "mad_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "mad_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = loaded("import plainref.judge, plainref.describe, "
                   "plainref.dock, plainref.sim, plainref.inputs, "
                   "plainref.eqsp")
    assert not names & {"mad_tpu_torch", "mad_tpu", "jax", "jaxlib",
                        "flax", "harness"}


def test_forbidden_names_compare_whole():
    sys.path[:0] = [str(BENCH)]
    from harness.runner import forbidden_modules
    assert forbidden_modules(["mad_tpu_torch", "mad_tpu_torch.engine",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "mad_tpu.api", "flax"]) == [
        "flax", "jax", "mad_tpu"]
