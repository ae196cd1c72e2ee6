"""Graph utilities of the combinatorial-optimization solver layer
(counterpart of ``elegantrl_tpu/rlsolver/graphs.py``; numpy only, so the
port keeps its own copy, and its own sample instances under ``data/``).

Gset txt files (header ``num_nodes num_edges``, then 1-indexed ``i j
weight`` lines), TSPLIB EUC_2D and Solomon VRPTW instances, the synthetic
BA / ER / PL generators, result files and their summary.  Graphs are dense
symmetric float32 adjacency matrices, which the simulators move onto their
device: a ``(num_sims, N) x (N, N)`` product evaluates every candidate.
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np

GraphEdges = np.ndarray  # (E, 3) [i, j, w] 0-indexed


def generate_graph(graph_type: str, num_nodes: int, seed: int = 0,
                   avg_degree: int = 4) -> GraphEdges:
    """Synthetic instance families matching the reference's generators:
    'ER' (Erdos-Renyi), 'BA' (Barabasi-Albert preferential attachment),
    'PL' (powerlaw cluster, approximated as BA + triangle closures)."""
    rng = np.random.default_rng(seed)
    edges = set()
    if graph_type.upper() == 'ER':
        p = avg_degree / max(num_nodes - 1, 1)
        for i in range(num_nodes):
            for j in rng.choice(num_nodes, size=max(1, int(p * num_nodes)), replace=False):
                if i < j:
                    edges.add((i, int(j)))
    elif graph_type.upper() in ('BA', 'PL'):
        m = max(1, avg_degree // 2)
        targets = list(range(m))
        repeated: List[int] = list(range(m))
        for v in range(m, num_nodes):
            for t in targets:
                if t != v:
                    edges.add((min(v, t), max(v, t)))
            repeated.extend(targets)
            repeated.extend([v] * len(targets))
            targets = [int(rng.choice(repeated)) for _ in range(m)]
            if graph_type.upper() == 'PL' and len(targets) >= 2 and rng.random() < 0.3:
                a, b = targets[0], targets[1]
                if a != b:
                    edges.add((min(a, b), max(a, b)))
    else:
        raise ValueError(f"unknown graph_type {graph_type}")
    e = sorted(edges)
    return np.array([[i, j, 1.0] for i, j in e], dtype=np.float64)


def read_graph_txt(path: str) -> Tuple[int, GraphEdges]:
    """Read a Gset-format txt (1-indexed) -> (num_nodes, edges 0-indexed)."""
    with open(path) as f:
        n, e = map(int, f.readline().split()[:2])
        rows = []
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                w = float(parts[2]) if len(parts) > 2 else 1.0
                rows.append((int(parts[0]) - 1, int(parts[1]) - 1, w))
    return n, np.array(rows, dtype=np.float64)


def write_graph_txt(path: str, num_nodes: int, edges: GraphEdges) -> None:
    with open(path, 'w') as f:
        f.write(f"{num_nodes} {len(edges)}\n")
        for i, j, w in edges:
            f.write(f"{int(i) + 1} {int(j) + 1} {int(w)}\n")


def read_tsplib(path: str) -> np.ndarray:
    """Read a TSPLIB ``.tsp`` file (EUC_2D node coordinates) -> (N, 2)
    float64 city array, the input format of :class:`tsp.TSPSimulator`.

    Covers the format the reference consumes (``rlsolver/data/tsplib/*.tsp``
    via ``methods/iSCO/config/config_tsp.py:9``): a keyword header
    (NAME/TYPE/DIMENSION/EDGE_WEIGHT_TYPE) followed by a
    ``NODE_COORD_SECTION`` of ``index x y`` lines terminated by ``EOF``.
    """
    dimension = None
    weight_type = 'EUC_2D'
    coords = {}
    in_coords = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line == 'EOF':
                continue
            if in_coords:
                parts = line.split()
                coords[int(parts[0])] = (float(parts[1]), float(parts[2]))
                continue
            key = line.split(':')[0].strip().upper()
            if key == 'DIMENSION':
                dimension = int(line.split(':')[1])
            elif key == 'EDGE_WEIGHT_TYPE':
                weight_type = line.split(':')[1].strip().upper()
            elif line.upper().startswith('NODE_COORD_SECTION'):
                in_coords = True
    if weight_type != 'EUC_2D':
        raise ValueError(f"unsupported EDGE_WEIGHT_TYPE {weight_type} "
                         f"(only EUC_2D coordinates are supported)")
    if not coords:
        raise ValueError(f"no NODE_COORD_SECTION in {path}")
    n = dimension or len(coords)
    cities = np.zeros((n, 2), np.float64)
    for idx, (x, y) in coords.items():
        cities[idx - 1] = (x, y)
    return cities


def write_tsplib(path: str, cities: np.ndarray, name: str = 'instance') -> None:
    """Write an (N, 2) city array as a TSPLIB EUC_2D ``.tsp`` file."""
    cities = np.asarray(cities)
    with open(path, 'w') as f:
        f.write(f"NAME: {name}\nTYPE: TSP\nDIMENSION: {len(cities)}\n"
                f"EDGE_WEIGHT_TYPE: EUC_2D\nNODE_COORD_SECTION\n")
        for i, (x, y) in enumerate(cities):
            f.write(f"{i + 1} {x} {y}\n")
        f.write("EOF\n")


def read_solomon(path: str) -> dict:
    """Read a Solomon VRPTW instance (the format of the reference's
    ``rlsolver/data/solomon-instances/c101.txt``): name line, VEHICLE
    section (``NUMBER CAPACITY``), CUSTOMER table of
    ``id x y demand ready due service`` rows (row 0 = depot).

    Returns ``{'name', 'num_vehicles', 'capacity', 'xy' (N,2),
    'demand' (N,), 'ready' (N,), 'due' (N,), 'service' (N,)}`` with the
    depot at index 0.
    """
    name = None
    vehicle_next = False
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if name is None:
                name = parts[0]
                continue
            if parts[0] == 'VEHICLE':
                continue
            if parts[0] == 'NUMBER':
                vehicle_next = True
                continue
            if vehicle_next:
                num_vehicles, capacity = int(parts[0]), float(parts[1])
                vehicle_next = False
                continue
            if parts[0] in ('CUSTOMER', 'CUST'):
                continue
            if len(parts) == 7 and parts[0].isdigit():
                rows.append([float(v) for v in parts])
    arr = np.array(sorted(rows, key=lambda r: r[0]), np.float64)
    return {'name': name, 'num_vehicles': num_vehicles, 'capacity': capacity,
            'xy': arr[:, 1:3], 'demand': arr[:, 3], 'ready': arr[:, 4],
            'due': arr[:, 5], 'service': arr[:, 6]}


def write_solomon(path: str, inst: dict) -> None:
    """Write an instance dict (see :func:`read_solomon`) in Solomon format."""
    with open(path, 'w') as f:
        f.write(f"{inst['name']}\n\nVEHICLE\nNUMBER     CAPACITY\n"
                f"  {inst['num_vehicles']}         {int(inst['capacity'])}\n\n"
                f"CUSTOMER\nCUST NO.  XCOORD.   YCOORD.    DEMAND   "
                f"READY TIME  DUE DATE   SERVICE   TIME\n \n")
        for i in range(len(inst['xy'])):
            f.write(f"    {i}      {inst['xy'][i][0]:g}         "
                    f"{inst['xy'][i][1]:g}          {inst['demand'][i]:g}"
                    f"          {inst['ready'][i]:g}       {inst['due'][i]:g}"
                    f"          {inst['service'][i]:g}   \n")


def data_path(*parts: str) -> str:
    """Path into the port's ``rlsolver/data`` sample-instance directory."""
    return os.path.join(os.path.dirname(__file__), 'data', *parts)


def edges_to_adjacency(edges: GraphEdges, num_nodes: int) -> np.ndarray:
    """(N, N) symmetric float32 adjacency."""
    adj = np.zeros((num_nodes, num_nodes), np.float32)
    for i, j, w in edges:
        adj[int(i), int(j)] += w
        adj[int(j), int(i)] += w
    return adj


def summarize_results(result_dir: str, output_csv: str = None,
                      maximize: bool = True) -> dict:
    """Aggregate result files written by :func:`write_graph_result` into
    per-(instance, algorithm) statistics — the role of the reference's
    ``methods/util_statistics.py:24`` (``process_folder``), which walks
    result folders, extracts the ``// obj:`` headers and writes per-category
    CSV summaries via pandas.  Here: stdlib-only, one pass.

    Returns ``{(instance, alg): {'avg_obj', 'std_obj', 'best_obj',
    'avg_time', 'count'}}`` and optionally writes one CSV row per key."""
    import csv
    import math

    runs = {}
    for name in sorted(os.listdir(result_dir)):
        if not name.endswith('.txt'):
            continue
        header = {}
        with open(os.path.join(result_dir, name)) as f:
            for line in f:
                if not line.startswith('//'):
                    break
                parts = line[2:].split(':', 1)
                if len(parts) == 2:
                    header[parts[0].strip()] = parts[1].strip()
        if 'obj' not in header or 'alg_name' not in header:
            continue
        alg = header['alg_name']
        # instance = filename minus the trailing _{alg}_{timestamp}.txt
        stem = name[:-4]
        marker = f"_{alg}_"
        instance = stem[:stem.rfind(marker)] if marker in stem else stem
        runs.setdefault((instance, alg), []).append(
            (float(header['obj']), float(header.get('running_duration', 0))))

    summary = {}
    for key, vals in runs.items():
        objs = [v[0] for v in vals]
        times = [v[1] for v in vals]
        mean = sum(objs) / len(objs)
        var = sum((o - mean) ** 2 for o in objs) / len(objs)
        summary[key] = {
            'avg_obj': mean,
            'std_obj': math.sqrt(var),
            'best_obj': max(objs) if maximize else min(objs),
            'avg_time': sum(times) / len(times),
            'count': len(objs),
        }

    if output_csv is not None:
        with open(output_csv, 'w', newline='') as f:
            w = csv.writer(f)
            w.writerow(['instance', 'alg', 'avg_obj', 'std_obj',
                        'best_obj', 'avg_time', 'count'])
            for (instance, alg), s in sorted(summary.items()):
                w.writerow([instance, alg, s['avg_obj'], s['std_obj'],
                            s['best_obj'], s['avg_time'], s['count']])
    return summary


def write_graph_result(obj: float, running_duration: float, num_nodes: int,
                       alg_name: str, solution: np.ndarray, filename: str,
                       plus1: bool = True) -> str:
    """Write a result file like the reference's
    ``util_result.write_graph_result`` (used by iSCO/main_maxcut.py:42):
    header comments with obj/time/alg, then 1-indexed node assignments."""
    directory = os.path.dirname(filename)
    if directory:
        os.makedirs(directory, exist_ok=True)
    # O_CREAT|O_EXCL makes creation atomic, so concurrent solver processes
    # writing the same instance/alg in the same second cannot clobber each
    # other (a bare exists() check would race between check and open)
    stamp = int(time.time())
    out, k = f"{filename}_{alg_name}_{stamp}.txt", 1
    while True:
        try:
            fd = os.open(out, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
            break
        except FileExistsError:
            out = f"{filename}_{alg_name}_{stamp}-{k}.txt"
            k += 1
    add = 1 if plus1 else 0
    with os.fdopen(fd, 'w') as f:
        f.write(f"// obj: {float(obj)}\n")
        f.write(f"// running_duration: {running_duration}\n")
        f.write(f"// num_nodes: {num_nodes}\n")
        f.write(f"// alg_name: {alg_name}\n")
        for node, val in enumerate(np.asarray(solution).astype(int)):
            f.write(f"{node + 1} {val + add}\n")
    return out
