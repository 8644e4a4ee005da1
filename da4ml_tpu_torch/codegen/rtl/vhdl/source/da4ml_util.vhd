-- Shared helpers for the da4ml_tpu VHDL primitive library: integer max and
-- sign-aware resize (sign-extend when S=1, zero-extend otherwise).
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;

package da4ml_util is
    function imax(a : integer; b : integer) return integer;
    function ext(v : std_logic_vector; s : integer; w : integer) return signed;
end package;

package body da4ml_util is
    function imax(a : integer; b : integer) return integer is
    begin
        if a > b then
            return a;
        end if;
        return b;
    end function;

    function ext(v : std_logic_vector; s : integer; w : integer) return signed is
    begin
        if s = 1 then
            return resize(signed(v), w);
        end if;
        return signed(resize(unsigned(v), w));
    end function;
end package body;
