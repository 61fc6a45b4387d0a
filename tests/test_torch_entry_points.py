"""The port's tools are installed as console scripts of their own
(pyproject.toml), beside the JAX package's and shadowing none of them:
the twin of tests/test_cli_surface.py's
``test_all_cli_tools_have_entry_points``."""

import importlib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = os.path.join(REPO, "astrophotography_tpu_torch", "cli")
PORT_TOOLS = sorted(f[:-3] for f in os.listdir(PORT_CLI)
                    if f.endswith(".py") and not f.startswith("_")
                    and f != "common.py")


def _scripts(package: str) -> dict:
    """{script name: tool module} of ``package``'s console scripts."""
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    return dict(re.findall(
        rf'^(\w+) = "{re.escape(package)}\.cli\.(\w+):main"$', text, re.M))


def test_all_port_cli_tools_have_entry_points():
    """Every port tool is a console script; no port script takes a JAX
    script's name; the JAX package's scripts are all still there."""
    port, jax = _scripts("astrophotography_tpu_torch"), \
        _scripts("astrophotography_tpu")
    missing = set(PORT_TOOLS) - set(port.values())
    assert not missing, f"port CLI tools without console scripts: {missing}"
    assert not set(port) & set(jax), set(port) & set(jax)
    jax_tools = {f[:-3] for f in os.listdir(os.path.join(REPO,
                                                         "astrophotography_tpu",
                                                         "cli"))
                 if f.endswith(".py") and not f.startswith("_")
                 and f != "common.py"}
    assert set(jax.values()) == jax_tools


@pytest.mark.parametrize("tool", PORT_TOOLS)
def test_port_script_names_its_tool(tool):
    """Each port script is the JAX script's name with ``_torch``, and its
    target is the tool's ``main``."""
    port = _scripts("astrophotography_tpu_torch")
    assert port[f"{tool}_torch"] == tool
    mod = importlib.import_module(f"astrophotography_tpu_torch.cli.{tool}")
    assert callable(mod.main)
