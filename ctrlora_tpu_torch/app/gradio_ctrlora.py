"""Main gradio UI of the port (counterpart of app/gradio_ctrlora.py;
reference app/gradio_ctrlora.py): single- and two-condition CtrLoRA
sampling with the preprocessors, prompt presets and guess mode, on the
card. Every callback is one call into ``ctrlora_tpu_torch.apps.logic``.

    python -m ctrlora_tpu_torch.app.gradio_ctrlora
"""

import os

try:
    import gradio as gr
except ImportError as e:  # pragma: no cover
    raise SystemExit(
        "gradio is not installed in this environment; the app logic lives in "
        "ctrlora_tpu_torch/apps/logic.py and is fully usable from python."
    ) from e

from ctrlora_tpu_torch.apps import logic

CKPT_SD15_DIR = "./ckpts/sd15"
CKPT_BASECN_DIR = "./ckpts/ctrlora-basecn"
CKPT_LORA_DIR = "./ckpts/ctrlora-loras"

state = logic.AppState()


def ui_detect(det, image, det_res, img_res):
    return [logic.detect(det, image, int(det_res), int(img_res))]


def ui_process(det, detected, prompt, a_prompt_sel, n_prompt_sel, extra_prompt,
               extra_nprompt, num_samples, ddim_steps, guess_mode, strength,
               scale, seed, eta, sd_ckpt, cn_ckpt, lora_ckpt):
    full_prompt = ", ".join(
        x for x in [prompt, logic.ADD_PROMPTS.get(a_prompt_sel, ""), extra_prompt] if x)
    full_nprompt = ", ".join(
        x for x in [logic.NEG_PROMPTS.get(n_prompt_sel, ""), extra_nprompt] if x)
    return state.process(
        det, detected, full_prompt, full_nprompt, int(num_samples), int(ddim_steps),
        bool(guess_mode), float(strength), float(scale), int(seed), float(eta),
        os.path.join(CKPT_SD15_DIR, sd_ckpt), os.path.join(CKPT_BASECN_DIR, cn_ckpt),
        os.path.join(CKPT_LORA_DIR, lora_ckpt))


def ui_process2(detected, detected2, prompt, n_prompt, num_samples, ddim_steps,
                guess_mode, strength, scale, seed, eta, sd_ckpt, cn_ckpt,
                lora_ckpt, lora2_ckpt, w1, w2):
    return state.process2(
        detected, detected2, prompt, n_prompt, int(num_samples), int(ddim_steps),
        float(strength), float(scale), int(seed), float(eta),
        os.path.join(CKPT_SD15_DIR, sd_ckpt), os.path.join(CKPT_BASECN_DIR, cn_ckpt),
        os.path.join(CKPT_LORA_DIR, lora_ckpt), os.path.join(CKPT_LORA_DIR, lora2_ckpt),
        float(w1), float(w2), guess_mode=bool(guess_mode))


def build_demo():
    ls = logic.ckpt_choices
    with gr.Blocks() as demo:
        gr.Markdown("## CtrLoRA (H100)")
        with gr.Tab("Single condition"):
            with gr.Row():
                with gr.Column():
                    sd_ckpt = gr.Dropdown(ls(CKPT_SD15_DIR), label="SD checkpoint")
                    cn_ckpt = gr.Dropdown(ls(CKPT_BASECN_DIR), label="Base ControlNet")
                    lora_ckpt = gr.Dropdown(ls(CKPT_LORA_DIR), label="LoRA")
                    det = gr.Dropdown(logic.DET_CHOICES, value="canny", label="Preprocessor")
                    image = gr.Image(label="Input image")
                    det_res = gr.Slider(128, 1024, value=512, step=64, label="Detect resolution")
                    img_res = gr.Slider(256, 768, value=512, step=64, label="Image resolution")
                    btn_detect = gr.Button("Detect")
                    detected = gr.Image(label="Condition")
                with gr.Column():
                    prompt = gr.Textbox(label="Prompt")
                    a_prompt_sel = gr.Dropdown(list(logic.ADD_PROMPTS), value="General-short",
                                               label="Added prompt preset")
                    n_prompt_sel = gr.Dropdown(list(logic.NEG_PROMPTS), value="General-short",
                                               label="Negative prompt preset")
                    extra_prompt = gr.Textbox(label="Extra added prompt")
                    extra_nprompt = gr.Textbox(label="Extra negative prompt")
                    num_samples = gr.Slider(1, 8, value=1, step=1, label="Samples")
                    ddim_steps = gr.Slider(1, 100, value=20, step=1, label="DDIM steps")
                    guess_mode = gr.Checkbox(label="Guess mode")
                    strength = gr.Slider(0.0, 2.0, value=1.0, label="Control strength")
                    scale = gr.Slider(0.1, 30.0, value=7.5, label="CFG scale")
                    seed = gr.Slider(-1, 65535, value=-1, step=1, label="Seed")
                    eta = gr.Slider(0.0, 1.0, value=0.0, label="eta (DDIM)")
                    btn_run = gr.Button("Generate")
                    gallery = gr.Gallery(label="Results")
            btn_detect.click(ui_detect, [det, image, det_res, img_res], [detected])
            btn_run.click(
                ui_process,
                [det, detected, prompt, a_prompt_sel, n_prompt_sel, extra_prompt,
                 extra_nprompt, num_samples, ddim_steps, guess_mode, strength,
                 scale, seed, eta, sd_ckpt, cn_ckpt, lora_ckpt],
                [gallery])
        with gr.Tab("Two conditions"):
            with gr.Row():
                with gr.Column():
                    sd2 = gr.Dropdown(ls(CKPT_SD15_DIR), label="SD checkpoint")
                    cn2 = gr.Dropdown(ls(CKPT_BASECN_DIR), label="Base ControlNet")
                    l1 = gr.Dropdown(ls(CKPT_LORA_DIR), label="LoRA 1")
                    l2 = gr.Dropdown(ls(CKPT_LORA_DIR), label="LoRA 2")
                    c1 = gr.Image(label="Condition 1")
                    c2 = gr.Image(label="Condition 2")
                    w1 = gr.Slider(0.0, 2.0, value=1.0, label="LoRA 1 weight")
                    w2 = gr.Slider(0.0, 2.0, value=1.0, label="LoRA 2 weight")
                with gr.Column():
                    prompt2 = gr.Textbox(label="Prompt")
                    nprompt2 = gr.Textbox(label="Negative prompt")
                    ns2 = gr.Slider(1, 8, value=1, step=1, label="Samples")
                    steps2 = gr.Slider(1, 100, value=20, step=1, label="DDIM steps")
                    guess2 = gr.Checkbox(label="Guess mode")
                    strength2 = gr.Slider(0.0, 2.0, value=1.0, label="Control strength")
                    scale2 = gr.Slider(0.1, 30.0, value=7.5, label="CFG scale")
                    seed2 = gr.Slider(-1, 65535, value=-1, step=1, label="Seed")
                    eta2 = gr.Slider(0.0, 1.0, value=0.0, label="eta")
                    btn2 = gr.Button("Generate")
                    gallery2 = gr.Gallery(label="Results")
            btn2.click(
                ui_process2,
                [c1, c2, prompt2, nprompt2, ns2, steps2, guess2, strength2,
                 scale2, seed2, eta2, sd2, cn2, l1, l2, w1, w2],
                [gallery2])
    return demo


if __name__ == "__main__":
    build_demo().launch(server_name="0.0.0.0")
