"""Optional exact-solver wrappers: Gurobi MILP/QUBO and SCIP (a copy of
``elegantrl_tpu/rlsolver/exact.py``, which imports no JAX: the port keeps
its own).

Capability match for the reference's ``rlsolver/methods/gurobi.py``
(``run_using_gurobi``, :258 — MaxCut as MILP or QUBO, license required) and
``methods/scip.py`` (``run_using_scip``, :75).  ``gurobipy`` and
``pyscipopt`` are optional (and Gurobi also needs a license), so these
wrappers import lazily and raise :class:`SolverUnavailable` when the
backend is absent; the model-building code runs where it is installed.

MaxCut MILP formulation (clean-room, standard):
    max  sum_{(i,j) in E} w_ij * y_ij
    s.t. y_ij <= x_i + x_j,   y_ij <= 2 - x_i - x_j,   x, y binary
(y_ij == 1 iff edge (i, j) is cut).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SolverUnavailable(ImportError):
    """Raised when an optional exact-solver backend is not installed."""


def _require(module: str, extra: str = ""):
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise SolverUnavailable(
            f"optional dependency '{module}' is not installed; install it to "
            f"use this exact solver{extra}. The batched on-device heuristics "
            f"(simulated_annealing / genetic_algorithm / mcpg_solve / "
            f"isco_solve) need no extra packages.") from e


def gurobi_solve_maxcut(edges: np.ndarray, num_nodes: int,
                        time_limit: Optional[float] = None
                        ) -> Tuple[float, np.ndarray]:
    """MaxCut via Gurobi MILP (reference ``run_using_gurobi``,
    methods/gurobi.py:258).  Returns (cut_value, x)."""
    gp = _require("gurobipy", extra=" (a Gurobi license is also required)")
    model = gp.Model("maxcut")
    if time_limit is not None:
        model.Params.TimeLimit = float(time_limit)
    x = model.addVars(num_nodes, vtype=gp.GRB.BINARY, name="x")
    obj = gp.LinExpr()
    for i, j, w in np.asarray(edges):
        i, j = int(i), int(j)
        y = model.addVar(vtype=gp.GRB.BINARY)
        model.addConstr(y <= x[i] + x[j])
        model.addConstr(y <= 2 - x[i] - x[j])
        obj += float(w) * y
    model.setObjective(obj, gp.GRB.MAXIMIZE)
    model.optimize()
    sol = np.array([x[i].X for i in range(num_nodes)])
    return float(model.ObjVal), (sol > 0.5).astype(np.float32)


def gurobi_solve_knapsack(values: np.ndarray, weights: np.ndarray,
                          capacity: float,
                          time_limit: Optional[float] = None
                          ) -> Tuple[float, np.ndarray]:
    """0/1 knapsack via Gurobi MILP (reference Problem.knapsack path)."""
    gp = _require("gurobipy", extra=" (a Gurobi license is also required)")
    n = len(values)
    model = gp.Model("knapsack")
    if time_limit is not None:
        model.Params.TimeLimit = float(time_limit)
    x = model.addVars(n, vtype=gp.GRB.BINARY)
    model.addConstr(gp.quicksum(float(weights[i]) * x[i] for i in range(n))
                    <= float(capacity))
    model.setObjective(gp.quicksum(float(values[i]) * x[i] for i in range(n)),
                       gp.GRB.MAXIMIZE)
    model.optimize()
    sol = np.array([x[i].X for i in range(n)])
    return float(model.ObjVal), (sol > 0.5).astype(np.float32)


def scip_solve_maxcut(edges: np.ndarray, num_nodes: int,
                      time_limit: Optional[float] = None
                      ) -> Tuple[float, np.ndarray]:
    """MaxCut via SCIP (reference ``run_using_scip``, methods/scip.py:75)."""
    scip = _require("pyscipopt")
    model = scip.Model("maxcut")
    if time_limit is not None:
        model.setParam("limits/time", float(time_limit))
    x = [model.addVar(vtype="B", name=f"x{i}") for i in range(num_nodes)]
    ys = []
    for i, j, w in np.asarray(edges):
        i, j = int(i), int(j)
        y = model.addVar(vtype="B")
        model.addCons(y <= x[i] + x[j])
        model.addCons(y <= 2 - x[i] - x[j])
        ys.append((y, float(w)))
    model.setObjective(scip.quicksum(w * y for y, w in ys), "maximize")
    model.optimize()
    sol = np.array([model.getVal(v) for v in x])
    return float(model.getObjVal()), (sol > 0.5).astype(np.float32)
