"""Entry point mirroring the reference `resume/modalities.py` evaluation, on
the port (counterpart of lirec_tpu/cli/modalities.py)."""

from lirec_tpu_torch.cli.common import run_entry


def main(argv=None):
    return run_entry("modalities", argv)


def script() -> int:
    """Console-script wrapper: main() returns data for programmatic use;
    setuptools wrappers sys.exit() the return value, so exit 0 here."""
    main()
    return 0


if __name__ == "__main__":
    main()
