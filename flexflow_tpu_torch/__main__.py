"""``python -m flexflow_tpu_torch script.py [flags]``: the script runner.

Counterpart of the JAX package's ``__main__.py`` (reference: python/main.cc
and flexflow_top.py:164-219, which run the user's script inside a Legion
top-level task).  No special interpreter is needed: the runner takes the
Legion-style ``-ll:*``/``-lg:*`` flags and their values out of the
script's argv, stashes the full list for ``FFConfig.parse_args(None)``
(``config.set_runner_argv``), and runs the script as ``__main__``.  Every
other flag, the port's own ``--device`` among them, reaches the script.
"""

import runpy
import sys


def script_argv(args):
    """``args`` without the ``-ll:*``/``-lg:*`` flags and their values."""
    out, i = [], 0
    while i < len(args):
        if args[i].startswith(("-ll:", "-lg:")):
            i += 2
            continue
        out.append(args[i])
        i += 1
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print("usage: python -m flexflow_tpu_torch <script.py> [args...]")
        return 1
    script, args = argv[0], argv[1:]
    from . import config

    config.set_runner_argv(args)
    sys.argv = [script] + script_argv(args)
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
