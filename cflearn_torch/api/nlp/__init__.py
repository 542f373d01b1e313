from .third_party.prompt import PromptConfig, PromptEnhanceAPI
