"""Shared build harness for the teaching notebooks.

The reference ships six rendered tutorial notebooks built by small
builder scripts (``/root/reference/notebooks/_build_nb01.py`` ...
``_build_nb06.py``).  This is the analogue here: each
``build_nbNN.py`` declares markdown/code cells and calls
:func:`build`, which executes the notebook end-to-end (so outputs are
committed) and writes the ``.ipynb``.

Execution pins ``JAX_PLATFORMS=cpu`` with x64 enabled: the notebooks
teach *semantics* (the math, the transforms, the parity checks), which
are platform-independent — ``jit``/``vmap``/``grad`` trace identically
on CPU and GPU.  Cells that discuss device-specific behaviour (kernels,
tiling, reduced precision) say so in prose.

Run from the ``notebooks/`` directory::

    python build_nb01.py          # writes + executes 01_*.ipynb
"""

from __future__ import annotations

import os
import sys

import nbformat as nbf
from nbconvert.preprocessors import ExecutePreprocessor
from nbformat.v4 import new_code_cell, new_markdown_cell, new_notebook

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def md(source: str):
    return new_markdown_cell(source)


def code(source: str):
    return new_code_cell(source)


PREAMBLE = (
    "# Environment: run from a clone of the repo (notebooks/ directory).\n"
    "# The notebooks teach platform-independent semantics; they run on CPU\n"
    "# or GPU unchanged. x64 is enabled so the f64 oracle columns in\n"
    "# the parity tables are exact.\n"
    "import os, sys\n"
    "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
    "sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), '..')))\n"
    "import jax\n"
    "# config.update, not just the env var: it holds even if jax was\n"
    "# imported before this cell.\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "jax.config.update('jax_enable_x64', True)\n"
    "import jax.numpy as jnp\n"
    "import numpy as np\n"
    "np.set_printoptions(precision=4, suppress=True)\n"
    "print('backend:', jax.default_backend(), '| devices:', len(jax.devices()))"
)


def build(filename: str, cells, timeout: int = 600) -> str:
    """Assemble, execute, and write ``notebooks/<filename>``."""
    nb = new_notebook(
        cells=list(cells),
        metadata={
            "kernelspec": {
                "display_name": "Python 3",
                "language": "python",
                "name": "python3",
            },
            "language_info": {"name": "python", "version": sys.version.split()[0]},
        },
    )
    ep = ExecutePreprocessor(timeout=timeout, kernel_name="python3")
    ep.preprocess(nb, {"metadata": {"path": HERE}})
    path = os.path.join(HERE, filename)
    with open(path, "w") as f:
        nbf.write(nb, f)
    n_code = sum(1 for c in nb.cells if c.cell_type == "code")
    print(f"wrote {path} ({len(nb.cells)} cells, {n_code} executed)")
    return path
