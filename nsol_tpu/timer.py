"""Timing and console utilities (pysitk.python_helper replacement).

The reference leans on pysitk for wall-clock timing
(ph.start_timing/stop_timing around Solver._run, nsol/solver.py:152-166)
and console printing (ph.print_info/print_title/print_subtitle). This module
re-provides that runtime-utility surface; device work is synchronized with
``block_until_ready`` before stopping the clock so device timings are honest.
"""

import datetime
import sys

__all__ = ["start_timing", "stop_timing", "print_info", "print_title",
           "print_subtitle", "block_and_stop_timing"]


def start_timing():
    return datetime.datetime.now()


def stop_timing(time_start):
    return datetime.datetime.now() - time_start


def block_and_stop_timing(time_start, *arrays):
    """Stop the clock only after all device work feeding ``arrays`` is done."""
    for a in arrays:
        if hasattr(a, "block_until_ready"):
            a.block_until_ready()
    return stop_timing(time_start)


def print_info(text, newline=True):
    out = "--- %s" % text
    if newline:
        print(out)
    else:
        sys.stdout.write(out)
        sys.stdout.flush()


def print_title(text, symbol="*"):
    line = symbol * 80
    print("\n" + line + "\n" + symbol + " " + text + "\n" + line)


def print_subtitle(text, symbol="*"):
    print("\n" + symbol * 3 + " " + text + " " + symbol * 3)
