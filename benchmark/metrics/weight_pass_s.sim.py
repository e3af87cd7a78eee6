"""Host seconds of the simulation recipe's weight pass in the timed
preparation: ``quantize_params`` (per-channel 4-bit grids with bit
allocation, bias correction), ending in a synchronise."""


def read(rec):
    return rec['prep']['weight_pass_s'] if rec['traffic']['path'] == 'sim' else None
