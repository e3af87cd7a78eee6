"""The simulation sweep's share of the card's float32 peak (%): 2 x the
multiply-accumulates of every conv and linear an image needs, times the
window's images/s, over 67 TFLOP/s (its convs run in float32 without TF32)."""


def read(rec):
    if rec['traffic']['path'] != 'sim':
        return None
    per_image = rec['work']['ops'] / rec['traffic']['batch']
    return 100.0 * per_image * rec['window']['images_per_s'] / rec['peaks']['fp32_flops']
