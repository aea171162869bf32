"""The tiny model and scan the CPU tests run the harness at."""

TINY = {"img_size": [64, 96], "enc_depth": 2, "enc_embed_dim": 64,
        "enc_num_heads": 4, "dec_depth": 4, "dec_embed_dim": 48,
        "dec_num_heads": 4, "desc_dim": 8, "feature_dim": 32, "last_dim": 16,
        "layer_dims": [16, 16, 16, 48], "dtype": "float32",
        "head_dtype": "float32"}

# limits of the 64x96 model's sound runs: its float32 network matches the
# reference to rounding, its coarse pixels track less exactly than the
# published size does
SIZES = {"model": TINY,
         "mix": {"orbit_frames": 17, "scan_frames": 200, "warm_frames": 9},
         "codebook_words": 256,
         "limits": {"enc_err": 1e-5, "asym_err": 1e-5, "sym_err": 1e-5,
                    "track_err": 0.15, "kf_err": 0.08, "kf_rot_err": 0.03}}
