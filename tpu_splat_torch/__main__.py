"""`python -m tpu_splat_torch` entry point."""

from .cli import main

raise SystemExit(main())
