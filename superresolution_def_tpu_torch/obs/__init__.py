from .loggers import SWIN_CSV_COLUMNS, CSVLogger
from .preview import save_tris_preview, to_u8

__all__ = ["SWIN_CSV_COLUMNS", "CSVLogger", "save_tris_preview", "to_u8"]
