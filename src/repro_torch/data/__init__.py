"""Data pipeline: TPC-H generator and catalog."""

from repro_torch.data.catalog import Catalog, TableMeta
from repro_torch.data.tpch import SCHEMAS, date_to_int, generate_tpch

__all__ = ["Catalog", "SCHEMAS", "TableMeta", "date_to_int", "generate_tpch"]
