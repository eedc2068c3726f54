"""The port's docs check (`tools/check_docs_torch.py`): clean on the tree
(README.md's "PyTorch / H100 port" section and the port's part of the
verify skill), and failing on a README copy with a `repro_torch.*`
reference to a module that does not exist and a flag that its entry
point does not define; `tools/check_docs.py` (the JAX package's check)
clean on the tree too."""
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "check_docs_torch", ROOT / "tools" / "check_docs_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_docs_check_passes_on_the_tree(capsys):
    assert _tool().main() == 0, capsys.readouterr().out
    out = subprocess.run([sys.executable, "tools/check_docs.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout


def test_port_docs_check_finds_a_bad_reference_and_flag():
    tool = _tool()
    text = (ROOT / "README.md").read_text()
    cmd = ("python -m repro_torch.launch.train --arch minicpm-2b "
           "--reduced --rounds 2 --device cpu")
    assert cmd in text and "`repro_torch.models.transformer`" in text
    bad = text.replace(cmd, cmd + " --no-such-flag", 1).replace(
        "`repro_torch.models.transformer`", "`repro_torch.models.transformr`",
        1)
    clean: list = []
    tool.check("README.md", tool.section(text), clean)
    assert clean == []
    errors: list = []
    tool.check("README.md", tool.section(bad), errors)
    assert len(errors) == 2, errors
    assert ("README.md: references missing module or name "
            "`repro_torch.models.transformr`") in errors
    assert ("README.md: flag `--no-such-flag` is not defined in "
            "src/repro_torch/launch/train.py") in errors
