"""Training entry point on the port (counterpart of lirec_tpu/cli/train.py):
``run_entry`` with ``--train``; an optional first positional argument picks
the preset (default ``int_rel_ch``).

    python -m lirec_tpu_torch.cli.train [preset] --data-root <root>
        [--epochs N] [--checkpoint-every N] [--resume-train --resume-path
        <store>/latest.pth.tar] [--host-eval] [--device cpu]
"""

import sys

from lirec_tpu_torch.cli.common import run_entry


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    preset = "int_rel_ch"
    if argv and not argv[0].startswith("-"):
        preset = argv.pop(0)
    return run_entry(preset, argv + ["--train"])


def script() -> int:
    """Console-script wrapper: main() returns data for programmatic use;
    setuptools wrappers sys.exit() the return value, so exit 0 here."""
    main()
    return 0


if __name__ == "__main__":
    main()
