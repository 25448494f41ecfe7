"""The gradio front ends of the port (counterpart of the repo's ``app/``):
``python -m ctrlora_tpu_torch.app.gradio_ctrlora`` (or ``gradio_controlnet``,
``gradio_ctrlora_style_transfer``). Each callback is one call into
``ctrlora_tpu_torch.apps.logic``; without gradio installed a module exits
with a message at import."""
