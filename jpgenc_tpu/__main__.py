from jpgenc_tpu.cli import run

raise SystemExit(run())
