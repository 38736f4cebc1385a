"""
Post-processing of FileHandler output (counterpart of
dedalus_tpu/tools/post.py; reference: dedalus/tools/post.py): one file
per output set, so merging concatenates sets, and the xarray loader
follows load_tasks_to_xarray (reference: tools/post.py:363). Needs h5py
(and xarray for the loader).
"""

import pathlib

import numpy as np

__all__ = ["get_assigned_sets", "merge_sets", "load_tasks_to_xarray"]


def get_assigned_sets(base_path):
    """Sorted set files of an output directory (reference:
    tools/post.py:20 visit_writes set enumeration)."""
    base_path = pathlib.Path(base_path)

    def set_number(p):
        tail = p.stem.rsplit("_s", 1)[1]
        return int(tail) if tail.isdigit() else None

    return sorted((p for p in base_path.glob(f"{base_path.name}_s*.h5")
                   if set_number(p) is not None), key=set_number)


def merge_sets(base_path, output=None, cleanup=False):
    """Concatenate all output sets of a handler directory into one file
    (reference: tools/post.py:166 merge_analysis, the serial case).
    Returns the merged file path."""
    import h5py
    base_path = pathlib.Path(base_path)
    sets = get_assigned_sets(base_path)
    if not sets:
        raise FileNotFoundError(f"No output sets under {base_path}")
    output = pathlib.Path(output) if output else \
        base_path / f"{base_path.name}_joint.h5"
    with h5py.File(output, "w") as out:
        scales = out.create_group("scales")
        tasks = out.create_group("tasks")
        buffers = {}
        for path in sets:
            with h5py.File(path, "r") as f:
                for group in ("scales", "tasks"):
                    for key in f[group]:
                        buffers.setdefault((group, key), []).append(
                            np.asarray(f[group][key]))
        for (group, key), chunks in buffers.items():
            target = scales if group == "scales" else tasks
            target.create_dataset(key, data=np.concatenate(chunks, axis=0))
    if cleanup:
        for path in sets:
            path.unlink()
    return output


def load_tasks_to_xarray(path, tasks=None):
    """Output tasks as xarray DataArrays keyed by name, with sim_time and
    write_number coordinates and the attached grid scales (reference:
    tools/post.py:363 load_tasks_to_xarray). Needs xarray."""
    import h5py
    import xarray
    path = pathlib.Path(path)
    out = {}
    with h5py.File(path, "r") as f:
        t = np.asarray(f["scales/sim_time"]) if "scales/sim_time" in f \
            else None
        writes = (np.asarray(f["scales/write_number"]).astype(int)
                  if "scales/write_number" in f else None)
        names = tasks or list(f["tasks"])
        for name in names:
            dset = f["tasks"][name]
            data = np.asarray(dset)
            dims = []
            coords = {}
            seen = set()
            for d in range(data.ndim):
                label = dset.dims[d].label or (
                    "t" if d == 0 else f"dim_{d - 1}")
                if label in seen:
                    label = f"{label}_{d}"
                seen.add(label)
                dims.append(label)
                if len(dset.dims[d]) and \
                        dset.dims[d][0].shape[0] == data.shape[d]:
                    coords[label] = (label, np.asarray(dset.dims[d][0]))
            if dims and dims[0] in ("write", "t"):
                dims[0] = "t"
            if t is not None:
                coords["t"] = ("t", t)
            if writes is not None:
                coords["write_number"] = ("t", writes)
            out[name] = xarray.DataArray(data, dims=dims, coords=coords,
                                         name=name)
    return out
