"""Clean-room Lua/Luau interpreter for the reference's demo script content
(≙ external/luau + src/lua/lua_script_system.cpp execution semantics)."""
from lumixengine_tpu_torch.script.lua.interp import (  # noqa: F401
    Interpreter, LuaCoroutine, LuaError, LuaFunction, LuaTable, lua_tostring,
    truthy,
)
from lumixengine_tpu_torch.script.lua.lexer import LuaSyntaxError  # noqa: F401
