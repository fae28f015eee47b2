"""UNet, motion modules and TAESD codec, channels-last."""
