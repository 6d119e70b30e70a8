"""What the tests of the port's experiments share: the JAX experiment
modules (top-level `experiments/`) and the flags a `main` defines, with
their defaults, read without running it."""

import argparse
import importlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def jax_experiment(name: str):
    """The JAX package's `experiments/<name>.py` module."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"experiments.{name}")


class _Parsed(Exception):
    pass


def flag_defaults(main, argv=None) -> dict:
    """{dest: default} of the parser `main` builds, captured at its
    `parse_args` call (which raises here, so nothing after it runs)."""
    original = argparse.ArgumentParser.parse_args

    def grab(self, *args, **kwargs):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = grab
    try:
        main() if argv is None else main(argv)
    except _Parsed as parsed:
        parser = parsed.args[0]
    else:
        raise AssertionError(f"{main} did not parse its arguments")
    finally:
        argparse.ArgumentParser.parse_args = original
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}
