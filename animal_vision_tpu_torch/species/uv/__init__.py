"""The UV species ported so far (counterparts of
``animal_vision_tpu.species.uv``); ``species/__init__.py`` registers them."""
