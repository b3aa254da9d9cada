from .options import build_parser, collate
