"""Condition annotators of the port (counterpart of
``ctrlora_tpu/annotators``): the numpy/cv2 detectors (``simple.py``), their
helpers (``util.py``) and the name registry (``registry.py``). The CNN
detectors are registered by name and raise NotImplementedError until they
are ported."""
