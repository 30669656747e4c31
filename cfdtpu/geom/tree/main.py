"""`tree` CLI subcommand: YAML config -> vascular tree -> tagged mesh.

Rebuild of /root/reference/src/geom/tree/main.py:11-57. The reference
pipeline is VascuSynth (C++ binary) -> GXL -> CadQuery solid -> gmsh .msh;
all three are offline preprocessing tools. This command runs whatever part
of the pipeline the environment supports and reports precisely what is
missing otherwise; GXL parsing, tree modifications and .msh ingestion are
always native.
"""

from __future__ import annotations

import os


def run(args) -> int:
    # lazy: PyYAML is needed by this subcommand only, and importing the
    # module must not require it
    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}

    workdir = cfg.get("workdir", os.path.dirname(args.output) or ".")
    tree_params = cfg.get("tree_params", cfg)

    from .vascusynth import generate_vascusynth_tree

    try:
        gxl = generate_vascusynth_tree(
            workdir,
            num_nodes=int(tree_params.get("n_terminal",
                                          tree_params.get("num_nodes", 32))),
            gamma=float(tree_params.get("gamma", 3.0)),
            random_seed=int(tree_params.get("seed",
                                            tree_params.get("random_seed",
                                                            0))),
            volume_mL=float(tree_params.get("volume_mL", 100.0)),
        )
    except RuntimeError as e:
        print(f"[tree] {e}")
        return 1

    print(f"[tree] GXL graph at {gxl}")

    from .tree_model import VascularTree
    from .vascusynth import voxel_width_mm

    tree = VascularTree.from_xml(
        gxl, voxel_width_mm(float(tree_params.get("volume_mL", 100.0)))
    )
    print(
        f"[tree] parsed: {len(tree.nodes)} nodes, {len(tree.edges)} "
        f"edges, {len(tree.terminals)} terminals"
    )

    # modifications from the config (prune/dilate/thicken,
    # reference tree_model.py:26-42)
    tree.apply_modifications(
        vessel_loss_factor=float(tree_params.get("vessel_loss_factor",
                                                 0.0)),
        hyperemia_factor=float(tree_params.get("hyperemia_factor", 1.0)),
        wall_severity=float(tree_params.get("wall_severity", 0.0)),
        wall_level_threshold=int(tree_params.get("wall_level_threshold",
                                                 0)),
    )

    # Native meshing: the reference needs CadQuery solids + gmsh here
    # (graph_to_mesh.py:186-401, both offline C++ tools); the implicit
    # capsule-union tet mesher produces the tagged .msh in-framework.
    from ..tree_mesh3d import tree_to_mesh3d
    from ...mesh.msh import write_msh

    res = float(tree_params.get("mesh_resolution", 0.35))
    mesh = tree_to_mesh3d(tree, res=res)
    out = args.output or os.path.join(workdir, "vessels.msh")
    if not out.endswith(".msh"):
        out = os.path.join(out, "vessels.msh")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_msh(mesh, out)
    n_out = int((mesh.facet_tags == 2).sum())
    print(
        f"[tree] meshed natively: {mesh.num_cells} tets, "
        f"{n_out} outlet facets -> {out}"
    )
    return 0
