"""The serving sweep's share of the card's int8 peak (%): 2 x the
multiply-accumulates of every conv and linear an image needs, times the
window's images/s, over 1,979 TOP/s."""


def read(rec):
    if rec['traffic']['path'] != 'serving' or rec['traffic']['loop'] != 'sweep':
        return None
    per_image = rec['work']['ops'] / rec['traffic']['batch']
    return 100.0 * per_image * rec['window']['images_per_s'] / rec['peaks']['int8_ops']
