"""The MST++ training tools (counterparts of the repository's
``tools/train_synth.py`` and ``tools/finetune_mixed.py``), each run as
``python -m animal_vision_tpu_torch.tools.<name>`` on the card unless
``--device cpu``."""
