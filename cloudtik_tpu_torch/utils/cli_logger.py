"""Structured, colored CLI output with grouped sections + confirmations.

Reference parity: core/_private/cli_logger.py (CliLogger, cf color helpers) —
re-designed small: one module-level logger object, context-manager groups,
click-based color when a TTY is attached.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any

import click


class _ColorFormat:
    """`cf` helper: cf.bold("..."), cf.green("...")."""

    def __getattr__(self, style: str):
        def fmt(text: str, *args: Any) -> str:
            text = text.format(*args) if args else text
            kwargs = {}
            if style in ("bold", "underlined"):
                kwargs["bold" if style == "bold" else "underline"] = True
            else:
                kwargs["fg"] = style
            try:
                return click.style(text, **kwargs)
            except TypeError:
                return text

        return fmt


cf = _ColorFormat()


class CliLogger:
    def __init__(self):
        self.indent_level = 0
        self.verbosity = 0
        self.interactive = sys.stdin.isatty() if hasattr(sys.stdin, "isatty") else False

    def _emit(self, msg: str, *args: Any, _stream=None) -> None:
        text = msg.format(*args) if args else msg
        prefix = "  " * self.indent_level
        click.echo(prefix + text, file=_stream or sys.stdout)

    def print(self, msg: str, *args: Any) -> None:
        self._emit(msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        self._emit(msg, *args)

    def verbose(self, msg: str, *args: Any) -> None:
        if self.verbosity > 0:
            self._emit(msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        self._emit(cf.yellow(msg.format(*args) if args else msg))

    def error(self, msg: str, *args: Any) -> None:
        self._emit(cf.red(msg.format(*args) if args else msg), _stream=sys.stderr)

    def success(self, msg: str, *args: Any) -> None:
        self._emit(cf.green(msg.format(*args) if args else msg))

    def abort(self, msg: str, *args: Any) -> None:
        self.error(msg, *args)
        raise SystemExit(1)

    def labeled_value(self, label: str, value: Any) -> None:
        self._emit("{}: {}", cf.bold(label), value)

    @contextlib.contextmanager
    def group(self, title: str, *args: Any):
        self._emit(cf.bold(title.format(*args) if args else title))
        self.indent_level += 1
        try:
            yield
        finally:
            self.indent_level -= 1

    def confirm(self, yes: bool, msg: str, *args: Any, _abort: bool = True) -> bool:
        """Ask for confirmation unless `yes` was passed."""
        if yes:
            return True
        if not self.interactive:
            if _abort:
                self.abort("Non-interactive session; pass --yes to proceed: " + msg)
            return False
        ok = click.confirm(msg.format(*args) if args else msg)
        if not ok and _abort:
            raise SystemExit(1)
        return ok


cli_logger = CliLogger()
