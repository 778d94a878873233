"""Evaluation prompt sets.

A copy of `adaface_tpu/evaluation/prompt_sets.py` (the JAX package's
`evaluation` package imports JAX on import): the dreambench-style lists of
`scripts/gen_prompts_and_eval.py:26-28` and the community and FreeU sets.
`{}` is the subject slot; the FreeU prompts have none.
"""

# DreamBooth-protocol prompts (public evaluation set layout)
DREAMBENCH_PROMPTS = [
    "a photo of {} in the jungle",
    "a photo of {} in the snow",
    "a photo of {} on the beach",
    "a photo of {} on a cobblestone street",
    "a photo of {} on top of pink fabric",
    "a photo of {} on top of a wooden floor",
    "a photo of {} with a city in the background",
    "a photo of {} with a mountain in the background",
    "a photo of {} with a blue house in the background",
    "a photo of {} on top of a purple rug in a forest",
    "a photo of {} wearing a red hat",
    "a photo of {} wearing a santa hat",
    "a photo of {} wearing a rainbow scarf",
    "a photo of {} wearing a black top hat and a monocle",
    "a photo of {} in a chef outfit",
    "a photo of {} in a firefighter outfit",
    "a photo of {} in a police outfit",
    "a photo of {} wearing pink glasses",
    "a photo of {} wearing a yellow shirt",
    "a photo of {} in a purple wizard outfit",
]

COMMUNITY_PROMPTS = [
    "portrait of {} as a renaissance noble, oil on canvas",
    "{} as an astronaut floating inside a space station",
    "{} laughing in the rain on a neon-lit street, cinematic",
    "watercolor painting of {} reading under a tree",
    "{} as a cyberpunk hacker with glowing visor",
    "{} in samurai armor standing in a bamboo grove",
    "low-poly 3d render of {}",
    "{} as a pixar character, studio lighting",
    "black and white street photography of {} crossing a bridge",
    "{} playing an accordion at a paris cafe",
    "{} as a medieval knight holding a banner",
    "pop-art poster of {} in four color panels",
    "{} surfing a large wave at sunset",
    "{} in a cozy sweater holding a cup of cocoa, snow outside",
    "sculpture of {} carved from white marble",
    "{} as a starship captain on the bridge, sci-fi lighting",
    "{} hiking a mountain ridge above the clouds",
    "anime illustration of {} under cherry blossoms",
    "{} conducting an orchestra, dramatic stage light",
    "{} as a detective in a rainy noir alley",
    "{} riding a hot air balloon over valleys",
    "stained glass window depicting {}",
    "{} in a flower field at golden hour, shallow depth of field",
    "{} dressed as a pirate on a ship deck",
    "{} as a chess grandmaster mid-game, focused",
    "charcoal sketch of {} smiling",
    "{} ice skating on a frozen lake at dusk",
    "{} in a library of floating books, fantasy art",
    "{} wearing a crown of autumn leaves, forest portrait",
    "{} as a race car driver holding a helmet",
    "claymation figure of {} waving",
    "{} meditating on a cliff edge at sunrise",
    "{} as a 19th century explorer with a map",
    "double-exposure portrait of {} and a galaxy",
    "{} baking bread in a rustic kitchen",
    "{} in a vaporwave dreamscape with palm trees",
    "{} as a superhero landing on a rooftop",
    "{} painting a mural on a city wall",
    "{} in traditional festival clothing, lantern light",
    "{} walking a tightrope between skyscrapers, surreal",
]

# Subject-free scene prompts for base-model / sampler-quality checks
# (equivalent of `evaluation/freeu_prompts.py` — prompts without a subject
# slot used to eyeball the backbone independent of personalization; ours is
# an own curation of the same flavor)
FREEU_PROMPTS = [
    "a lighthouse on a cliff during a thunderstorm, dramatic sky",
    "night market street food stalls under paper lanterns",
    "aurora borealis over a frozen fjord, long exposure",
    "an old steam train crossing a stone viaduct in fog",
    "macro photo of dew drops on a spider web at dawn",
    "a fox curled up asleep in fresh snow",
    "isometric render of a tiny floating island village",
    "a jazz band of robots playing in a smoky club",
    "hot air balloons drifting over desert canyons at sunrise",
    "an underwater city with glass domes and kelp forests",
    "a library inside a hollowed-out giant tree, warm light",
    "time-lapse star trails above an observatory",
    "a samurai standing in a field of pampas grass, wind",
    "low-angle shot of skyscrapers dissolving into clouds",
    "a cottage garden overflowing with wildflowers, oil painting",
    "a whale breaching in front of a container ship",
    "paper boats racing down a rainy gutter, shallow focus",
]

PROMPT_SETS = {
    "dreambench": DREAMBENCH_PROMPTS,
    "community": COMMUNITY_PROMPTS,
    "freeu": FREEU_PROMPTS,
    "all": DREAMBENCH_PROMPTS + COMMUNITY_PROMPTS,
}
