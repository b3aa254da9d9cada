from .pipe import ReadPipe, ReadPipeConfig, ReadPipeReport
