"""Multi-device statistics over ``torch.distributed`` (port of
``voicebridge_tpu/parallel``): ``mesh.py`` holds the mesh and the sharded
E-step, accumulator and decode builders, ``data.py`` the input pipeline."""
