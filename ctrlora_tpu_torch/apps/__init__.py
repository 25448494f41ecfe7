"""The apps' logic without their UI (counterpart of ``ctrlora_tpu/apps``)."""
