from .loggers import HAT_CSV_COLUMNS, SWIN_CSV_COLUMNS, CSVLogger, TensorBoardLogger
from .preview import save_tris_preview, to_u8
from .profiling import ThroughputMeter, trace

__all__ = ["HAT_CSV_COLUMNS", "SWIN_CSV_COLUMNS", "CSVLogger", "TensorBoardLogger",
           "ThroughputMeter", "save_tris_preview", "to_u8", "trace"]
