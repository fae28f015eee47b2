"""UNet, motion modules, TAESD codec and DPT-hybrid depth model, channels-last."""
