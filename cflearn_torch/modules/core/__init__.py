from . import activations, attentions, convs, customs, high_level, lora, mappings, mixed_stacks, ml_encoder, norms
