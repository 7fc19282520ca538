"""dmd-era5-tpu: a JAX spatiotemporal decomposition engine.

Public API parity with the reference package facade
(/root/reference/src/dmd_era5/__init__.py:9-39) plus the
extensions: distributed SVD, optimized DMD, forecasting, and the
parallelism layer.
"""

from __future__ import annotations

__version__ = "0.1.0"

from dmd_era5_tpu.core import (
    config_parser,
    config_reader,
    log_and_print,
    setup_logger,
)
from dmd_era5_tpu.snapmat import (
    apply_delay_embedding,
    create_mock_era5,
    create_mock_era5_svd,
    flatten_era5_variables,
    resample_era5_dataset,
    slice_era5_dataset,
    space_coord_to_level_lat_lon,
    standardize_data,
)
from dmd_era5_tpu.models import (
    DMDResult,
    OptDMDResult,
    exact_dmd,
    fit_optdmd,
    optdmd_from_svd,
    rollout,
)
from dmd_era5_tpu.ops import (
    SVDResult,
    exact_truncated_svd,
    randomized_svd,
    truncated_svd,
    tsqr,
)
from dmd_era5_tpu.parallel import make_mesh, shard_rows
from dmd_era5_tpu.pipeline import (
    add_data_to_dvc,
    add_data_to_store,
    download_era5_data,
    retrieve_data_from_dvc,
    retrieve_data_from_store,
)
from dmd_era5_tpu.utils import Coord, Field, FieldSet

__all__ = [
    "DMDResult",
    "OptDMDResult",
    "exact_dmd",
    "fit_optdmd",
    "optdmd_from_svd",
    "rollout",
    "SVDResult",
    "exact_truncated_svd",
    "randomized_svd",
    "truncated_svd",
    "tsqr",
    "make_mesh",
    "shard_rows",
    "add_data_to_store",
    "retrieve_data_from_store",
    "add_data_to_dvc",
    "retrieve_data_from_dvc",
    "download_era5_data",
    "__version__",
    "config_reader",
    "config_parser",
    "setup_logger",
    "log_and_print",
    "create_mock_era5",
    "create_mock_era5_svd",
    "slice_era5_dataset",
    "resample_era5_dataset",
    "standardize_data",
    "flatten_era5_variables",
    "apply_delay_embedding",
    "space_coord_to_level_lat_lon",
    "Coord",
    "Field",
    "FieldSet",
]
