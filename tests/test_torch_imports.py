"""The port stands alone: no file of ``opendht_tpu_torch/`` and not
``chip_smoke.py`` imports JAX, the JAX package, ``msgpack`` or
``argon2`` (the port carries its own MessagePack codec,
``utils/mpack.py``, and its own Argon2i, ``native/argon2.cpp``)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "opendht_tpu", "msgpack", "argon2")


def _port_files():
    return sorted((ROOT / "opendht_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert len(files) >= 6
    assert all(f.exists() for f in files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_list_covers_msgpack(tmp_path):
    """The scan sees each way a module can name ``msgpack``."""
    for src in ("import msgpack", "from msgpack import packb",
                "import msgpack.fallback as m", "__import__('msgpack')"):
        f = tmp_path / "m.py"
        f.write_text(src + "\n")
        assert set(_imported_roots(f)) & set(FORBIDDEN) == {"msgpack"}, src
