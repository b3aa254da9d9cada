"""Command-line entry point (``octopus-tpu-torch``).

Option surface follows the reference CLI (src/config/option_parser.cpp /
website/docs/cli.md); see octopus_tpu_torch.config.options for the full
flag set and the --device option.

Error handling mirrors src/main.cpp:27-41 + src/logging/error_handler.cpp:
every structured error prints a three-part where/why/help message; unknown
exceptions escaping the run are reported as a program error ("results may
be untrustworthy", octopus.cpp:1485-1555) rather than a raw traceback.
"""

from __future__ import annotations

import os
import sys

from .config.options import build_parser, parse_args_with_config
from .errors import CallingBug, OctopusError, UserError, format_error


def _report(err: OctopusError, debug: bool = False) -> int:
    print(format_error(err), file=sys.stderr)
    if debug and getattr(err, "cause", None) is not None:
        import traceback
        traceback.print_exception(err.cause, file=sys.stderr)
    return err.exit_code


def main(argv: list[str] | None = None) -> int:
    try:
        args = parse_args_with_config(argv)
    except OctopusError as e:
        return _report(e)
    if args.version:
        from . import __version__
        print(f"octopus-tpu-torch {__version__}")
        return 0
    debug = bool(getattr(args, "debug", None) or os.environ.get("OCTOPUS_TPU_DEBUG"))
    if not args.reference or not (args.reads or args.reads_file):
        return _report(UserError(
            "no reference (-R/--reference) or no reads (-I/--reads / "
            "--reads-file) were given, and both are required to call variants",
            where="options",
            help="pass --reference genome.fa and --reads sample.bam; run "
                 "octopus-tpu-torch --help for the full option list"))
    from .logging_.progress import init_logging
    init_logging(debug=bool(args.debug), trace=bool(args.trace),
                 log_file=args.trace or args.debug)
    try:
        if getattr(args, "filter_vcf", None):
            from .csr_run import run_filter_vcf
            return run_filter_vcf(args)
        from .run import run_calling
        return run_calling(args)
    except OctopusError as e:
        return _report(e, debug)
    except KeyboardInterrupt:
        print("octopus-tpu-torch: interrupted", file=sys.stderr)
        return 130
    except BaseException as e:  # noqa: BLE001 - the CallingBug contract
        if isinstance(e, SystemExit):
            raise
        if debug:
            import traceback
            traceback.print_exc(file=sys.stderr)
        return _report(CallingBug(e), debug=False)


if __name__ == "__main__":
    raise SystemExit(main())
