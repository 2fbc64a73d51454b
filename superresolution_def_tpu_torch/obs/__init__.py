from .loggers import HAT_CSV_COLUMNS, SWIN_CSV_COLUMNS, CSVLogger
from .preview import save_tris_preview, to_u8

__all__ = ["HAT_CSV_COLUMNS", "SWIN_CSV_COLUMNS", "CSVLogger", "save_tris_preview", "to_u8"]
