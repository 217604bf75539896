"""Every port test module runs on one intra-op thread, pinned in one place.

The driver's suite runs several xdist workers on shared cores; a torch
process with its default pool (one thread per core) in each of them makes
small ops wait on one another. ``tests/torch_threads.py`` holds the pin;
these tests keep every ``tests/test_torch_*.py`` on it.
"""

import ast
from pathlib import Path

import torch

from torch_threads import one_intra_op_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
PIN_MODULE, PIN = "torch_threads", "one_intra_op_thread"


def _thread_fixtures(path):
    """Names of the fixtures in ``path`` that call ``set_num_threads``."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not any("fixture" in ast.unparse(d) for d in node.decorator_list):
            continue
        calls = (n for n in ast.walk(node) if isinstance(n, ast.Call))
        if any(isinstance(c.func, ast.Attribute) and c.func.attr == "set_num_threads"
               for c in calls):
            names.append(node.name)
    return names


def _imports_the_pin(path):
    return any(isinstance(n, ast.ImportFrom) and n.module == PIN_MODULE
               and any(a.name == PIN and a.asname is None for a in n.names)
               for n in ast.parse(path.read_text(), str(path)).body)


def test_every_port_test_module_imports_the_one_thread_pin():
    port_modules = sorted(TESTS.glob("test_torch_*.py"))
    assert len(port_modules) >= 35
    missing = [p.name for p in port_modules if not _imports_the_pin(p)]
    assert not missing, f"import {PIN} from {PIN_MODULE} in: {missing}"
    pins = {p.name: f for p in sorted(TESTS.glob("*.py")) if (f := _thread_fixtures(p))}
    assert pins == {"torch_threads.py": [PIN]}, (
        f"one thread fixture, in torch_threads.py; found {pins}")


def test_the_imported_pin_holds_this_module_at_one_thread():
    assert torch.get_num_threads() == 1
