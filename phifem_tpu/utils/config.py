"""Scheme configuration: one dataclass serializable to/from YAML.

Replaces the reference's scattered config surface (argparse ``bg|sub`` CLIs,
YAML parameter files for interface-elasticity
``demo/interface-elasticity/param1.yaml:1-21``, top-of-file constants,
``MODE=debug`` env) with a single pytree-friendly config (SURVEY.md
section 5 "Config/flag system" rebuild note).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple


@dataclasses.dataclass
class SchemeConfig:
    """Parameters shared by all five schemes; field names mirror the
    reference YAML keys where they exist."""

    scheme: str = "weak-dirichlet"
    mode: str = "bg"  # "bg" (box_mode) | "sub" (submesh)
    cell_type: str = "triangle"
    bbox: Tuple[Tuple[float, float], Tuple[float, float]] = ((-1.0, -1.0), (1.0, 1.0))
    nx: int = 200
    ny: int = 200
    initial_mesh_size: Optional[float] = None  # alternative to nx/ny (S5 yaml)
    num_iterations: int = 1  # refinement levels for convergence loops
    primal_degree: int = 1
    flux_degree: int = 1
    auxiliary_degree: int = 0
    levelset_degree: int = 1
    boundary_detection_degree: int = 1
    single_layer_cut: bool = False
    penalization_coefficient: float = 1.0
    stabilization_coefficient: float = 1.0
    solver: str = "bicgstab"
    tol: float = 1e-10
    debug: bool = False

    def resolve_resolution(self) -> Tuple[int, int]:
        """S5-style: derive nx/ny from initial_mesh_size + bbox (reference
        ``demo/interface-elasticity/main.py:96-97``)."""
        if self.initial_mesh_size is None:
            return self.nx, self.ny
        (x0, y0), (x1, y1) = self.bbox
        nx = int(abs(x1 - x0) / self.initial_mesh_size)
        ny = int(abs(y1 - y0) / self.initial_mesh_size)
        return nx, ny


def _scalar(text: str):
    """One YAML scalar of the parameter files: bool, null, number, or a
    (possibly quoted) string."""
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~"):
        return None
    try:
        return json.loads(text)  # ints, floats, quoted strings
    except ValueError:
        pass
    try:
        return float(text)  # YAML floats JSON refuses, e.g. ``1.``
    except ValueError:
        return text.strip("'\"")


def parse_flat_yaml(text: str) -> dict:
    """The flat subset of YAML the parameter files use: ``key: value``
    lines, ``#`` comments, and a block list of ``- [a, b]`` rows under a
    key with no value (``bbox``).  Lets :func:`load_config` run where
    PyYAML is not installed."""
    out: dict = {}
    key = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        item = line.lstrip()
        if item.startswith("- "):
            out[key].append(json.loads(item[2:]))
            continue
        key, sep, val = line.partition(":")
        if not sep:
            raise ValueError(f"unsupported parameter line: {raw!r}")
        key, val = key.strip(), val.strip()
        out[key] = _scalar(val) if val else []
    return out


def load_config(path: str) -> SchemeConfig:
    """Load YAML (or JSON) into a SchemeConfig; accepts the reference's S5
    YAML schema (bbox given column-wise as [[x0,x1],[y0,y1]], see
    ``main.py:107-109`` where it is transposed).  Without PyYAML the flat
    schema of those files is parsed by :func:`parse_flat_yaml`."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml  # type: ignore

        raw = yaml.safe_load(text)
    except ImportError:
        try:
            raw = json.loads(text)
        except ValueError:
            raw = parse_flat_yaml(text)

    known = {f.name for f in dataclasses.fields(SchemeConfig)}
    kwargs = {k: v for k, v in raw.items() if k in known}
    if "bbox" in raw:
        bb = raw["bbox"]
        # reference S5 yaml stores [[x0, x1], [y0, y1]]
        kwargs["bbox"] = ((bb[0][0], bb[1][0]), (bb[0][1], bb[1][1]))
    if "box_mode" in raw:
        kwargs["mode"] = "bg" if raw["box_mode"] else "sub"
    return SchemeConfig(**kwargs)
