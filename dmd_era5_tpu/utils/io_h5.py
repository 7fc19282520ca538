"""HDF5 serialization of FieldSets, netCDF4-compatible on disk.

The reference writes NetCDF4 via xarray (/root/reference/src/dmd_era5/
era5_download/era5_download.py:114, era5_svd/era5_svd.py:434), and its
README documents artifacts as "readable by xarray"
(/root/reference/README.md:97-119).  NetCDF4 files *are* HDF5 files
following a handful of conventions; with no netCDF bindings in this
environment we emit those conventions directly with h5py, so
``xarray.open_dataset(path)`` (h5netcdf/netCDF4 engines) opens our
artifacts unmodified:

- data variables and coordinate variables are ROOT-group datasets;
- every dimension is an HDF5 *dimension scale* attached to each
  variable's axis (``CLASS = "DIMENSION_SCALE"`` + ``DIMENSION_LIST``
  references — what netCDF4-c itself writes);
- dimensions without a coordinate get the netCDF hidden-scale marker
  (``NAME = "This is a netCDF dimension but not a netCDF variable."``)
  so readers expose the dim but no phantom variable;
- auxiliary coordinates (e.g. ``original_variable`` over the ``space``
  dim) are listed in the CF ``coordinates`` attribute of each data
  variable, which is how xarray distinguishes them from data;
- times are int64 with CF units ``nanoseconds since 1970-01-01``,
  which xarray decodes back to datetime64[ns].

``load_fieldset`` reads both this layout and the legacy grouped layout
(``/vars`` + ``/coords``) from earlier artifacts.

h5py is imported lazily.  Where it is not installed, ``save_fieldset``
writes the same FieldSet as an ``.npz`` container (numpy only: arrays
plus a JSON manifest of dims, coords and attrs) under the same path, and
``load_fieldset`` recognizes either format by its magic bytes.  Such a
file is not netCDF-readable.

Tuple-valued coordinates are not serializable (same restriction NetCDF
has) — callers run ``space_coord_to_level_lat_lon`` first, exactly as
the reference does before saving (era5_svd.py:425).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

from dmd_era5_tpu.utils.labels import Coord, Field, FieldSet

__all__ = ["save_fieldset", "load_fieldset"]

_TIME_UNIT = "nanoseconds since 1970-01-01"
# the exact marker netCDF4-c puts on coordinate-less dimension scales
_NC_HIDDEN_DIM = "This is a netCDF dimension but not a netCDF variable."
# HDF5/netCDF machinery attributes that are not Field attrs
_RESERVED_ATTRS = {
    "dims",
    "coordinates",
    "CLASS",
    "NAME",
    "REFERENCE_LIST",
    "DIMENSION_LIST",
    "_Netcdf4Dimid",
    "_Netcdf4Coordinates",
    "_NCProperties",
}


def _have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def _encode_attr(value: Any):
    import h5py

    if isinstance(value, (list, tuple)):
        if all(isinstance(v, str) for v in value):
            return np.asarray(value, dtype=h5py.string_dtype())
        return np.asarray(value)
    if isinstance(value, bool):
        return int(value)
    if value is None:
        return "__none__"
    if isinstance(value, dict):
        return "__json__" + json.dumps(value)
    return value


def _decode_attr(value: Any):
    import h5py

    if isinstance(value, bytes):
        value = value.decode()
    if isinstance(value, str):
        if value == "__none__":
            return None
        if value.startswith("__json__"):
            return json.loads(value[len("__json__") :])
        return value
    if isinstance(value, np.ndarray):
        if value.dtype.kind in ("S", "O") or h5py.check_string_dtype(value.dtype):
            return [v.decode() if isinstance(v, bytes) else str(v) for v in value]
        return value
    if isinstance(value, np.generic):
        return value.item()
    return value


def _encode_array(values: np.ndarray) -> tuple[np.ndarray, dict]:
    import h5py

    meta: dict[str, Any] = {}
    if values.dtype.kind == "M":  # datetime64
        meta["units"] = _TIME_UNIT
        return values.astype("datetime64[ns]").astype(np.int64), meta
    if values.dtype.kind in ("U", "O"):
        return np.asarray(
            [str(v) for v in values.ravel()], dtype=h5py.string_dtype()
        ).reshape(values.shape), meta
    return values, meta


def _decode_array(ds: h5py.Dataset) -> np.ndarray:
    import h5py

    values = ds[()]
    if ds.attrs.get("units") == _TIME_UNIT or (
        isinstance(ds.attrs.get("units"), bytes)
        and ds.attrs["units"].decode() == _TIME_UNIT
    ):
        return values.astype("datetime64[ns]")
    if h5py.check_string_dtype(ds.dtype):
        return np.asarray(
            [v.decode() if isinstance(v, bytes) else v for v in values.ravel()],
            dtype=object,
        ).reshape(values.shape)
    return values


def _str_list_attr(values) -> np.ndarray:
    import h5py

    return np.asarray(list(values), dtype=h5py.string_dtype())


def _collect_coords(fs: FieldSet) -> dict[str, Coord]:
    """Union of the fields' coords, consistency-checked."""
    coords: dict[str, Coord] = {}
    for field in fs.data_vars.values():
        for cname, coord in field.coords.items():
            if cname in coords:
                if not (coords[cname] == coord):
                    raise ValueError(
                        f"Inconsistent coord {cname!r} across fields"
                    )
            else:
                coords[cname] = coord
    return coords


def save_fieldset(fs: FieldSet, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not _have_h5py():
        _save_npz(fs, path)
        return
    import h5py

    coords = _collect_coords(fs)
    with h5py.File(path, "w") as f:
        for key, value in fs.attrs.items():
            f.attrs[key] = _encode_attr(value)

        # ---- dim sizes ----
        dim_sizes: dict[str, int] = {}
        for field in fs.data_vars.values():
            for d, n in zip(field.dims, np.asarray(field.data).shape):
                dim_sizes[d] = n
        for coord in coords.values():
            for d, n in zip(coord.dims, np.asarray(coord.values).shape):
                dim_sizes.setdefault(d, n)

        def write_dataset(name: str, values: np.ndarray, dims) -> h5py.Dataset:
            arr, meta = _encode_array(values)
            ds = f.create_dataset(name, data=arr)
            ds.attrs["dims"] = _str_list_attr(dims)
            for k, v in meta.items():
                ds.attrs[k] = v
            return ds

        # ---- dimension scales: coord vars where dims == (name,) ----
        for cname, coord in coords.items():
            if tuple(coord.dims) == (cname,):
                ds = write_dataset(cname, np.asarray(coord.values), coord.dims)
                ds.make_scale(cname)
        # hidden scales for dimensions without a coordinate variable
        for d, n in dim_sizes.items():
            if d not in f:
                ds = f.create_dataset(d, shape=(n,), dtype="f4")
                ds.make_scale(d)
                # overwrite NAME with the netCDF hidden-dimension marker
                del ds.attrs["NAME"]
                ds.attrs["NAME"] = np.bytes_(
                    (_NC_HIDDEN_DIM + "%10d") % n
                )

        def attach(ds: h5py.Dataset, dims) -> None:
            for i, d in enumerate(dims):
                ds.dims[i].attach_scale(f[d])

        # ---- auxiliary coordinates (dims != (name,)) ----
        aux_names: list[str] = []
        for cname, coord in coords.items():
            if tuple(coord.dims) != (cname,):
                ds = write_dataset(cname, np.asarray(coord.values), coord.dims)
                attach(ds, coord.dims)
                aux_names.append(cname)

        # ---- data variables ----
        for name, field in fs.data_vars.items():
            if name in f:
                raise ValueError(
                    f"Data variable {name!r} collides with a coordinate"
                )
            ds = write_dataset(name, np.asarray(field.data), field.dims)
            attach(ds, field.dims)
            aux_here = [c for c in field.coords if c in aux_names]
            if aux_here:
                ds.attrs["coordinates"] = " ".join(aux_here)
            for k, v in field.attrs.items():
                ds.attrs[k] = _encode_attr(v)


def _load_legacy(f: h5py.File) -> FieldSet:
    """The pre-netCDF grouped layout (/vars + /coords)."""
    attrs = {k: _decode_attr(v) for k, v in f.attrs.items()}
    coords: dict[str, Coord] = {}
    for cname, cds in f["coords"].items():
        dims = tuple(d.decode() if isinstance(d, bytes) else d
                     for d in cds.attrs["dims"])
        coords[cname] = Coord(dims, _decode_array(cds))
    data_vars: dict[str, Field] = {}
    for name, ds in f["vars"].items():
        dims = tuple(d.decode() if isinstance(d, bytes) else d
                     for d in ds.attrs["dims"])
        field_attrs = {
            k[len("attr_") :]: _decode_attr(v)
            for k, v in ds.attrs.items()
            if k.startswith("attr_")
        }
        field_coords = {
            cname: coord
            for cname, coord in coords.items()
            if all(d in dims for d in coord.dims)
        }
        data_vars[name] = Field(
            _decode_array(ds), dims, field_coords, field_attrs, name
        )
    return FieldSet(data_vars, attrs=attrs)


def _is_hidden_scale(ds: h5py.Dataset) -> bool:
    name = ds.attrs.get("NAME")
    if isinstance(name, bytes):
        name = name.decode()
    return isinstance(name, str) and name.startswith(_NC_HIDDEN_DIM)


def _dims_of(ds: h5py.Dataset, fallback: str) -> tuple[str, ...]:
    if "dims" in ds.attrs:
        return tuple(
            d.decode() if isinstance(d, bytes) else d for d in ds.attrs["dims"]
        )
    # pure netCDF files (no "dims" attr): recover from attached scales
    out = []
    for i, dim in enumerate(ds.dims):
        keys = list(dim.keys())
        out.append(dim[keys[0]].name.lstrip("/") if keys else f"{fallback}_{i}")
    return tuple(out)


def load_fieldset(path: str | Path) -> FieldSet:
    with open(path, "rb") as f:
        if f.read(4) == _NPZ_MAGIC:
            return _load_npz(path)
    import h5py

    with h5py.File(path, "r") as f:
        if "vars" in f and isinstance(f["vars"], h5py.Group):
            return _load_legacy(f)

        attrs = {
            k: _decode_attr(v)
            for k, v in f.attrs.items()
            if k not in _RESERVED_ATTRS
        }
        datasets = {
            name: obj
            for name, obj in f.items()
            if isinstance(obj, h5py.Dataset)
        }
        # classification: dimension scales -> dim coords; names listed
        # in any CF "coordinates" attr -> aux coords; the rest -> data
        coord_names: set[str] = set()
        for name, ds in datasets.items():
            cls = ds.attrs.get("CLASS")
            if isinstance(cls, bytes):
                cls = cls.decode()
            if cls == "DIMENSION_SCALE" and not _is_hidden_scale(ds):
                coord_names.add(name)
        for ds in datasets.values():
            listed = ds.attrs.get("coordinates")
            if listed is not None:
                if isinstance(listed, bytes):
                    listed = listed.decode()
                coord_names.update(str(listed).split())

        coords: dict[str, Coord] = {}
        for cname in sorted(coord_names):
            ds = datasets[cname]
            coords[cname] = Coord(_dims_of(ds, cname), _decode_array(ds))

        data_vars: dict[str, Field] = {}
        for name, ds in datasets.items():
            if name in coord_names or _is_hidden_scale(ds):
                continue
            dims = _dims_of(ds, name)
            field_attrs = {
                k: _decode_attr(v)
                for k, v in ds.attrs.items()
                if k not in _RESERVED_ATTRS
                and not (k == "units" and _decode_attr(v) == _TIME_UNIT)
            }
            field_coords = {
                cname: coord
                for cname, coord in coords.items()
                if all(d in dims for d in coord.dims)
            }
            data_vars[name] = Field(
                _decode_array(ds), dims, field_coords, field_attrs, name
            )
    return FieldSet(data_vars, attrs=attrs)


# ---------------------------------------------- numpy-only container

_NPZ_MAGIC = b"PK\x03\x04"  # zip local-file header: every .npz


def _json_value(value: Any):
    """JSON form of a nested attr value (complex and arrays tagged)."""
    if isinstance(value, np.ndarray):
        return {"__nd__": _json_value(value.tolist()), "dtype": value.dtype.str}
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, complex):
        return {"__complex__": [value.real, value.imag]}
    if isinstance(value, (list, tuple)):
        return [_json_value(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _json_value(v) for k, v in value.items()}
    return value


def _from_json(value: Any):
    if isinstance(value, dict):
        if "__nd__" in value:
            return np.asarray(_from_json(value["__nd__"]), dtype=value["dtype"])
        if "__complex__" in value:
            return complex(*value["__complex__"])
        return {k: _from_json(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_from_json(v) for v in value]
    return value


def _npz_attrs(attrs: dict) -> dict:
    """Top-level attr normalization of the HDF5 path: bools as ints,
    non-string lists as arrays."""
    out = {}
    for key, value in attrs.items():
        if isinstance(value, bool):
            value = int(value)
        elif isinstance(value, (list, tuple)) and not all(
            isinstance(v, str) for v in value
        ):
            value = np.asarray(value)
        out[key] = _json_value(value)
    return out


def _npz_array(values) -> np.ndarray:
    values = np.asarray(values)
    if values.dtype.kind == "O":
        return np.asarray(
            [str(v) for v in values.ravel()], dtype=str
        ).reshape(values.shape)
    return values


def _npz_restore(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind == "U":  # strings come back as objects (HDF5 parity)
        return values.astype(object)
    return values


def _save_npz(fs: FieldSet, path: Path) -> None:
    coords = _collect_coords(fs)
    manifest = {
        "attrs": _npz_attrs(fs.attrs),
        "coords": {c: list(coord.dims) for c, coord in coords.items()},
        "vars": {
            name: {
                "dims": list(field.dims),
                "coords": list(field.coords),
                "attrs": _npz_attrs(field.attrs),
            }
            for name, field in fs.data_vars.items()
        },
    }
    arrays = {f"c/{c}": _npz_array(coord.values) for c, coord in coords.items()}
    arrays.update(
        {f"v/{n}": _npz_array(field.data) for n, field in fs.data_vars.items()}
    )
    arrays["manifest"] = np.asarray(json.dumps(manifest))
    with open(path, "wb") as f:  # a file object: savez adds no suffix
        np.savez(f, **arrays)


def _load_npz(path: str | Path) -> FieldSet:
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        coords = {
            c: Coord(tuple(dims), _npz_restore(z[f"c/{c}"]))
            for c, dims in manifest["coords"].items()
        }
        data_vars = {
            name: Field(
                _npz_restore(z[f"v/{name}"]),
                tuple(meta["dims"]),
                {c: coords[c] for c in meta["coords"]},
                _from_json(meta["attrs"]),
                name,
            )
            for name, meta in manifest["vars"].items()
        }
    return FieldSet(data_vars, attrs=_from_json(manifest["attrs"]))
