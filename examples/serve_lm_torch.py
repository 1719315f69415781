"""Serve a small model with batched requests through the port's decode
engine (continuous batching over fixed cache slots).

  PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma2-27b --requests 8
  PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3-1.7b --device cpu

The flags of ``examples/serve_lm.py``, plus ``--device`` (the card by
default).
"""

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
