"""Structured user-facing errors: the reference's Error hierarchy.

Mirrors src/exceptions/error.hpp:20-80 (type/where/why/help interface),
the concrete errors under src/exceptions/ (missing_file_error.cpp,
missing_index_error.cpp, malformed_file_error.cpp, ...), and the central
formatter in src/logging/error_handler.cpp (log_error: type line, indented
why paragraph, "To help resolve this error ..." help paragraph).

Every failure a user can cause (bad path, malformed input, contradictory
flags) must surface as one of these — never a raw traceback.  Unknown
exceptions escaping the calling loop are wrapped in :class:`CallingBug`,
the reference's "results may be untrustworthy" program error
(src/core/octopus.cpp:1485-1555).

Exit codes: user errors exit 2 (argparse convention), system and program
errors exit 1 (the reference uses EXIT_FAILURE for all; we keep 2 for user
mistakes so scripts can tell misuse from breakage).
"""

from __future__ import annotations

import os

_LINE_WIDTH = 72
_INDENT = "    "


class OctopusError(Exception):
    """Base of all structured errors (error.hpp:20-44).

    type: who is responsible — "user", "system", or "program".
    where: which component noticed (a hint, not a stacktrace).
    why: a detailed explanation of what went wrong.
    help: what the user can do about it.
    """

    type = "unclassified"
    exit_code = 1

    def __init__(self, why: str, *, where: str = "unknown",
                 help: str = "submit an error report to the developers"):
        super().__init__(why)
        self.where = where
        self.why = why
        self.help = help


class UserError(OctopusError):
    """Any error caused by bad user input (user_error.hpp)."""

    type = "user"
    exit_code = 2


class SystemError_(OctopusError):
    """Errors attributable to the environment, not user or program
    (system_error.hpp): vanished files, exhausted memory, dead workers."""

    type = "system"
    exit_code = 1


class ProgramError(OctopusError):
    """A bug in octopus-tpu itself (program_error.hpp)."""

    type = "program"
    exit_code = 1

    def __init__(self, why: str, *, where: str = "unknown",
                 help: str = ("submit an error report to "
                              "https://github.com/luntergroup/octopus/issues "
                              "with your command line and the debug log")):
        super().__init__(why, where=where, help=help)


# ---------------------------------------------------------------------------
# concrete user errors
# ---------------------------------------------------------------------------

class HeavyWindowDeferred(Exception):
    """Not an error: a CPU-only pool worker declines a window so the
    card's parent runs it (only when the caller config's defer_heavy is
    set): a dense active region (begin, end), or a genotype reduction of
    device size (IndividualModel; no region)."""

    def __init__(self, begin: int | None = None, end: int | None = None):
        super().__init__("heavy window deferred to parent" if begin is None
                         else f"heavy window {begin}-{end} deferred to parent")
        self.begin = begin
        self.end = end


class MissingFileError(UserError):
    """missing_file_error.cpp:22-44."""

    def __init__(self, path: str, kind: str | None = None, *,
                 where: str = "unknown", option: str | None = None):
        kind_s = f"{kind} " if kind else ""
        opt_s = f" (from {option})" if option else ""
        link = ""
        if os.path.islink(path):
            link = f" ({os.path.realpath(path)})"
        super().__init__(
            f"the {kind_s}file that you specified '{path}'{link}{opt_s} "
            "does not exist",
            where=where,
            help="ensure the specified path is correct and the file is readable")
        self.path = path


class MissingIndexError(UserError):
    """missing_index_error.cpp:20-41."""

    def __init__(self, associate: str, kind: str, *, where: str = "unknown",
                 index_hint: str | None = None):
        hint = (f" (expected {index_hint})" if index_hint else "")
        super().__init__(
            f"no associated index file could be found for the {kind} file "
            f"'{associate}'{hint}",
            where=where,
            help="index the file (e.g. samtools index / tabix) or check the "
                 "index sits next to it with the conventional extension")
        self.path = associate


class MalformedFileError(UserError):
    """malformed_file_error.cpp."""

    def __init__(self, path: str, kind: str | None = None, *,
                 detail: str | None = None, where: str = "unknown",
                 help: str | None = None):
        kind_s = f"{kind} " if kind else ""
        detail_s = f": {detail}" if detail else ""
        super().__init__(
            f"the {kind_s}file '{path}' is not in the format the file "
            f"extension indicates{detail_s}",
            where=where,
            help=help or "check the file is not corrupt or truncated, and "
                         "that the extension matches the actual format")
        self.path = path


class UnwritableFileError(UserError):
    """unwritable_file_error.cpp."""

    def __init__(self, path: str, *, where: str = "unknown"):
        super().__init__(
            f"the file you specified '{path}' could not be created or "
            "written",
            where=where,
            help="ensure the directory exists and you have write permission "
                 "there")
        self.path = path


class BadRegionError(UserError):
    """Bad -T/-K region syntax or an unknown contig
    (io/region/region_parser.cpp:96-140 error paths)."""

    def __init__(self, text: str, *, reason: str | None = None,
                 known_contigs: list[str] | None = None,
                 where: str = "parse_region"):
        reason_s = f": {reason}" if reason else ""
        hint = ""
        if known_contigs:
            show = ", ".join(known_contigs[:5])
            more = ", ..." if len(known_contigs) > 5 else ""
            hint = f"; reference contigs are [{show}{more}]"
        super().__init__(
            f"could not parse the genomic region '{text}'{reason_s}{hint}",
            where=where,
            help="use the format contig[:begin[-end]] with positions in the "
                 "contig bounds (zero-based half-open unless "
                 "--one-based-indexing)")


class ConflictingOptionsError(UserError):
    """Contradictory command-line flags (option_collation.cpp throws
    InvalidCommandLineOptions for these)."""

    def __init__(self, why: str, *, where: str = "options"):
        super().__init__(
            why, where=where,
            help="remove or change one of the conflicting command line "
                 "options; see --help or docs/cli.md for how they interact")


class MissingSampleError(UserError):
    def __init__(self, missing: list[str], available: list[str], *,
                 where: str = "read_manager"):
        super().__init__(
            f"the requested samples {sorted(missing)} are not present in any "
            f"input read file (available samples: {sorted(available)})",
            where=where,
            help="check the spelling against the SM tags in the read file "
                 "headers, or drop --samples to call every sample")


class CallingBug(ProgramError):
    """An unexpected exception escaped the calling loop: results written so
    far may be untrustworthy (octopus.cpp:1485-1555 run_octopus's
    catch-all, which also cleans up temporary state)."""

    def __init__(self, cause: BaseException, *, where: str = "run_calling"):
        super().__init__(
            "an unexpected error occurred "
            f"({type(cause).__name__}: {cause}) and any results written so "
            "far may be untrustworthy; this is likely a bug in octopus-tpu",
            where=where)
        self.cause = cause


# ---------------------------------------------------------------------------
# formatter (error_handler.cpp:log_error)
# ---------------------------------------------------------------------------

def _tidy(message: str) -> str:
    """capitalise_front + ensure trailing '.' (error_handler.cpp:18-23)."""
    message = message.strip()
    if message and message[0].islower():
        message = message[0].upper() + message[1:]
    if message and message[-1] not in ".!?":
        message += "."
    return message


def _paragraph(message: str, width: int) -> list[str]:
    """Greedy word wrap (error_handler.cpp:format_as_paragraph)."""
    words = message.split()
    lines: list[str] = []
    cur = ""
    for w in words:
        if len(cur) + len(w) + 1 > width and cur:
            lines.append(cur)
            cur = w
        else:
            cur = f"{cur} {w}" if cur else w
    if cur:
        lines.append(cur)
    return lines


def format_error(err: OctopusError) -> str:
    article = "An" if err.type == "unclassified" else "A"
    out = [f"{article} {err.type} error has occurred:", ""]
    out += [_INDENT + l
            for l in _paragraph(_tidy(err.why), _LINE_WIDTH - len(_INDENT))]
    out.append("")
    help_text = err.help.strip()
    if help_text:
        help_text = help_text[0].lower() + help_text[1:]
    out += _paragraph(_tidy(f"To help resolve this error {help_text}"),
                      _LINE_WIDTH)
    return "\n".join(out)


__all__ = [
    "OctopusError", "UserError", "SystemError_", "ProgramError",
    "MissingFileError", "MissingIndexError", "MalformedFileError",
    "UnwritableFileError", "BadRegionError", "ConflictingOptionsError",
    "MissingSampleError", "CallingBug", "HeavyWindowDeferred", "format_error",
]
