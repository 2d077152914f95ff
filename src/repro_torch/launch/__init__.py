"""Launchers: ``train.py`` (the LM rounds, one process or one rank a
(pod, data) shard), ``serve.py`` (batched prefill + decode), ``mesh.py``
(the meshes) and ``dryrun.py`` (per-device bytes of every target on the
production meshes)."""
