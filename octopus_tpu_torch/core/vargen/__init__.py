from .cigar_scanner import ScannerOptions
