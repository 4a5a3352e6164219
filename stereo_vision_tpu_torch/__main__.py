"""python -m stereo_vision_tpu_torch: the CLI entry (see pipeline.cli)."""

from stereo_vision_tpu_torch.pipeline.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
